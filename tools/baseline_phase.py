#!/usr/bin/env python3
"""chip_smoke.py's baseline configs phase alone, on one card.

    python3 tools/baseline_phase.py [--only c1,c3] 2>&1 | tee baseline.log

Builds the kernels (and meanwhile the configs' worlds), starts the side process (`chip_smoke.HostChecks`),
runs `chip_smoke.baseline_phase` (BASELINE.json's c1, c2, c3 and c5 at full
width, each held to the JAX package's solve, `chip_smoke.BASELINE_JAX`),
then waits for the side process's verdicts (the oracle's partitions of c1
and c2, K5's plain version on each config's decode). `--only` keeps the
configs whose names start with the given prefixes. Exits 0 when every
check held, 1 when one failed, 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("baseline_phase: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from karpenter_tpu_torch import _build

    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        keep = tuple(sys.argv[2].split(","))
        for name in list(CS.BASELINE_JAX):
            if not name.startswith(keep):
                del CS.BASELINE_JAX[name]
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as ex:
        building = ex.submit(_build.build_all)
        ready = CS.baseline_worlds()
        CS.log(f"worlds built on the host while nvcc runs: {time.monotonic() - t0:.1f}s")
        built = building.result()
    CS.log(f"build {time.monotonic() - t0:.1f}s for {len(built)} libraries")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    CS.log(f"card: {smi}")
    host = CS.HostChecks()
    try:
        host.start()
        out = CS.baseline_phase(torch.device("cuda"), host, ready)
        if out is not None:
            CS.baseline_late_timing(out, torch.device("cuda"), t0)
        checks = host.finish()
    finally:
        host.close()
    if checks is None:
        return 1
    verdicts = checks.pop("verdicts")
    CS.log(f"host checks: {json.dumps({n: (v['bad'] or 'equal', round(v['plain_ms'], 1)) for n, v in verdicts.items()})}; "
           f"side process {json.dumps(checks)}")
    if out is None or any(v["bad"] for v in verdicts.values()):
        CS.log("baseline configs phase FAILED")
        return 1
    CS.log(f"baseline configs phase ok in {out['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
