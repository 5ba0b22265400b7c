#!/usr/bin/env python3
"""chip_smoke.py's phase 14 alone, on one card.

    python3 tools/operator_phase.py 2>&1 | tee chiprun_out/operator.log

Builds the kernels, times the headline solve as chip_smoke.py's headline
phase does (a warm-up, then the median of 3) for the steady figure, then
runs `chip_smoke.cold_start_phase` (two fresh processes' first solve with
and without `aot.prewarm()`, and the sidecar's prewarm with a solve sent
mid-prewarm) and `chip_smoke.operator_phase` (the port's Operator: the
10100-pod settle, the 2040-pod consolidation round against the oracle's
Operator, the probes and the device trace). Exits 0 when every check
held, 1 when one failed, 2 without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("operator_phase: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from karpenter_tpu_torch import _build

    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    t0 = time.monotonic()
    built = _build.build_all()
    oracle = CS.RecordProcess()
    try:
        oracle.start()
        return _phase14(CS, built, t0, oracle)
    finally:
        oracle.close()


def _phase14(CS, built, t0, oracle) -> int:
    import torch

    CS.log(f"build {time.monotonic() - t0:.1f}s for {len(built)} libraries")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    CS.log(f"card: {smi}")
    dev = torch.device("cuda")
    its = CS.build_universe(CS.HEADLINE_TYPES)
    times = []
    for _ in range(4):
        sched, pods = CS.scheduler_for(CS.headline_world(CS.HEADLINE_PODS, its), dev)
        t0 = time.monotonic()
        sched.solve(pods)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    steady = sorted(times[1:])[1]
    CS.log(f"headline solve seconds (a warm-up, then 3): {[round(x, 4) for x in times]}; median {steady:.4f}s")
    cold = CS.cold_start_phase(dev, its, steady)
    operator = CS.operator_phase(dev, its, oracle) if cold is not None else None
    if cold is None or operator is None:
        CS.log("phase 14 FAILED")
        return 1
    CS.log(f"phase 14 ok: cold start {cold['seconds']:.1f}s, operator {operator['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
