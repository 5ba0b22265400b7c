#!/usr/bin/env python3
"""chip_smoke.py's sidecar phase (13b) alone, on one card.

    python3 tools/sidecar_phase.py 2>&1 | tee chiprun_out/sidecar.log

Builds the kernels, reconciles chip_smoke.py's entry cluster (the c6 mix
plus its PVC pods) in-process on the card for the claims the sidecar's
reconcile must equal, then runs `chip_smoke.sidecar_phase`: the port's
SolverServer on a unix socket at the headline's width, its checks (a)-(f)
and the server-side phases beside the in-process solve's. Exits 0 when
every check held, 1 when one failed, 2 without a CUDA device.
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
        print("sidecar_phase: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from karpenter_tpu_torch import _build

    t0 = time.monotonic()
    built = _build.build_all()
    CS.log(f"build {time.monotonic() - t0:.1f}s for {len(built)} libraries")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    CS.log(f"card: {smi}")
    dev = torch.device("cuda")
    its = CS.build_universe(CS.HEADLINE_TYPES)
    prov = CS.entry_cluster(CS.C6_PODS, CS.ENTRY_PVC_PODS, its, dev)
    t0 = time.monotonic()
    res = prov.reconcile(ignore_batcher=True)
    torch.cuda.synchronize()
    CS.log(f"entry reconcile in-process {time.monotonic() - t0:.2f}s solver={prov.last_solver_used}")
    out = CS.sidecar_phase(dev, its, CS.claims_view(res.created_claims))
    CS.log(f"sidecar phase {'ok' if out else 'FAILED'}: "
           f"{out and {k: v for k, v in out.items() if k != 'phases'}}")
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
