#!/usr/bin/env python3
"""The JAX package's kernel odometer on the c6 realistic mix, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/reference_odometer.py [n_pods]

Builds bench.py's c6 problem (`build_universe(500)`,
`make_problem(n_pods, its, pods_realistic)`: 98% of the headline's diverse
mix plus a 2% tail of preference pods, default 10000 pods), solves it with
the JAX package's `TpuScheduler` and prints one JSON line with the solve's
path and odometer. chip_smoke.py pins these structure counts
(`C6_JAX_ODOMETER`) for the port's solve of the same problem on the card.
"""

import json
import os
import sys
import time

os.environ.setdefault("KARPENTER_COMPILATION_CACHE_DIR", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import bench
    from karpenter_tpu.solver.tpu import TpuScheduler

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    its = bench.build_universe(500)
    pools, ibp, pods, topo = bench.make_problem(n, its, bench.pods_realistic)
    sched = TpuScheduler(pools, ibp, topo)
    t0 = time.monotonic()
    res = sched.solve(pods)
    print(json.dumps({
        "pods": n, "seconds": round(time.monotonic() - t0, 2), "runs_path": sched.last_used_runs,
        "relax": sched.last_relax, "claims": len(res.new_node_claims), "errors": len(res.pod_errors),
        "odometer": sched.last_odometer,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
