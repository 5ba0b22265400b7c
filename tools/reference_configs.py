#!/usr/bin/env python3
"""The JAX package's solves of the BASELINE.json configs, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/reference_configs.py [c1|c2|c3|c5 ...] [--oracle]

Builds each config with bench.py's own makers (`build_universe`,
`make_problem` and the config's pod and pool makers), solves it with the
JAX package's `TpuScheduler` and prints one JSON line a config: the path
(`runs_path`), `relax`, the claim and error counts, the odometer and
`digest`, the port's `fuzz.snapshot_digest` of the JAX package's
`fuzz.results_snapshot`. chip_smoke.py pins these lines (`BASELINE_JAX`)
for the port's solves of the same problems on the card. Default: all four.

With `--oracle`, the configs chip_smoke.py's side process referees
(`BASELINE_ORACLE`: c1 and c2) are also solved by the port's oracle on the
port's own build of the config (`karpenter_tpu_torch.testing.configs`),
and the line says whether its `chip_smoke.partition_view` equals the JAX
package's (`oracle_partition_equal`) and how long the oracle took.
"""

import json
import os
import resource
import sys
import time

os.environ.setdefault("KARPENTER_COMPILATION_CACHE_DIR", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from karpenter_tpu_torch.testing.configs import CONFIGS  # noqa: E402

# short name ("c1") -> the config's BENCH_DETAIL.json row name
SHORT = {name.split("_", 1)[0]: name for name in CONFIGS}


def reference_line(short: str) -> tuple:
    """(the config's JSON record, the JAX package's Results, its pods): the
    config built by bench.py's own makers of the same names."""
    import bench
    from karpenter_tpu.solver.tpu import TpuScheduler
    from karpenter_tpu.testing import fuzz
    from karpenter_tpu_torch.testing.fuzz import snapshot_digest

    name = SHORT[short]
    cfg = CONFIGS[name]
    its = bench.build_universe(cfg.types)
    pools, ibp, pods, topo = bench.make_problem(
        cfg.pods, its, *(getattr(bench, fn.__name__) if fn else None for fn in (cfg.pods_fn, cfg.pools_fn))
    )
    sched = TpuScheduler(pools, ibp, topo)
    t0 = time.monotonic()
    res = sched.solve(pods)
    rec = {
        "config": name, "pods": len(pods), "types": len(its), "seconds": round(time.monotonic() - t0, 2),
        "runs_path": sched.last_used_runs, "relax": sched.last_relax, "claims": len(res.new_node_claims),
        "errors": len(res.pod_errors), "odometer": sched.last_odometer,
        "digest": snapshot_digest(fuzz.results_snapshot(res, pods)),
    }
    return rec, res, pods


def oracle_fields(short: str, res, pods) -> dict:
    """The port's oracle on the port's build of the config, against the
    JAX package's Results by `chip_smoke.partition_view`."""
    from karpenter_tpu_torch.solver.oracle import Scheduler
    from karpenter_tpu_torch.testing import configs

    pools, ibp, opods, topo = configs.build(SHORT[short])
    t0 = time.monotonic()
    got = Scheduler(pools, ibp, topo).solve(opods)
    secs = time.monotonic() - t0
    mism = chip_smoke.partition_mismatches(chip_smoke.partition_view(got, opods), chip_smoke.partition_view(res, pods))
    return {"oracle_seconds": round(secs, 2), "oracle_partition_equal": not mism, "oracle_mismatches": mism}


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--oracle"]
    with_oracle = "--oracle" in sys.argv[1:]
    bad = [a for a in args if a not in SHORT]
    if bad:
        print(f"unknown config {bad}; choose from {sorted(SHORT)}", file=sys.stderr)
        return 2
    for short in args or list(SHORT):
        rec, res, pods = reference_line(short)
        if with_oracle and SHORT[short] in chip_smoke.BASELINE_ORACLE:
            rec.update(oracle_fields(short, res, pods))
        rec["max_rss_mib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
