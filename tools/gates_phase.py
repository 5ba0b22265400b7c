#!/usr/bin/env python3
"""chip_smoke.py's gates phase alone, on one card.

    python3 tools/gates_phase.py 2>&1 | tee chiprun_out/gates.log

Builds the kernels (and meanwhile the phase's fleets: `chip_smoke.gates_worlds`),
starts the side process (`chip_smoke.HostChecks`, whose forked children hold
the referee checks) and the gated Operator's card and oracle sides
(`chip_smoke.py --gates-card`, `--gates-oracle`), runs `chip_smoke.gates_phase` (a replace
Command at the c4 width, Drift, Emptiness and the Validator's vetoes,
StaticDrift's reservations, the Operator with all five feature gates on and
the table cache across an overlay change), then a fresh process's prewarm with
its fleet lanes and a 2-lane fleet window after it
(`chip_smoke.py --cold-start prewarm`, checked by
`chip_smoke.prewarm_fleet_checks`), and waits for the referees' verdicts.
Exits 0 when every check held, 1 when one failed, 2 without a CUDA device.
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
        print("gates_phase: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from karpenter_tpu_torch import _build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.chdir(root)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as ex:
        building = ex.submit(_build.build_all)
        worlds = CS.gates_worlds()
        CS.log(f"fleets built on the host while nvcc runs: {time.monotonic() - t0:.1f}s")
        built = building.result()
    CS.log(f"build {time.monotonic() - t0:.1f}s for {len(built)} libraries")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    CS.log(f"card: {smi}")
    host, oracle, card = CS.HostChecks(), CS.gates_oracle(), CS.gates_card()
    CS._CHILDREN.extend((host, oracle, card))
    try:
        host.start()
        oracle.start()
        card.start()
        out = CS.gates_phase(torch.device("cuda"), host, card, oracle, worlds)
        del worlds
        t1 = time.monotonic()
        proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"), "--cold-start", "prewarm"],
                              cwd=root, capture_output=True, text=True, timeout=CS.COLD_START_TIMEOUT)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("COLD_START ")), None)
        if proc.returncode != 0 or line is None:
            CS.log(f"cold start (prewarm): exit {proc.returncode}; {proc.stderr[-2000:]}")
            prewarm_bad = ["the fresh process"]
        else:
            a = json.loads(line[len("COLD_START "):])
            CS.log(f"cold start (prewarm): {time.monotonic() - t1:.1f}s, prewarm {a['prewarm_s']:.2f}s "
                   f"{json.dumps(a['prewarm'])}, launches in the prewarm {json.dumps(a['launches_prewarm'])}")
            prewarm_bad = CS.prewarm_fleet_checks(a)
        checks = host.finish()
    finally:
        for child in CS._CHILDREN:
            child.close()
    if checks is None:
        return 1
    verdicts = checks.pop("verdicts")
    CS.log(f"host checks: {json.dumps({n: (v['bad'] or 'equal', round(v['plain_ms'], 1)) for n, v in verdicts.items()})}; "
           f"side process {json.dumps(checks)}")
    if out is None or prewarm_bad or any(v["bad"] for v in verdicts.values()):
        CS.log(f"gates phase FAILED {prewarm_bad}")
        return 1
    CS.log(f"gates phase ok in {out['seconds']:.1f}s; launches {json.dumps(out['launches'])}; card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
