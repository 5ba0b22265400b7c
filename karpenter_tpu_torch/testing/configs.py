"""The BASELINE.json configurations, built on the port's own objects.

The port's copy of bench.py's config makers: the KWOK catalog cut to n
types (`build_universe`), a problem made from seed 42 (`make_problem`), and
each config's pod mix and NodePools. Sizes are the configs' own:

- c1_500x50_requests_only: 500 pods of requests only on 50 types;
- c2_10kx500_selector_taints: 10000 pods, each with a zone nodeSelector
  and a toleration of the "team" taint, on 500 types, under a default
  NodePool and a tainted NodePool of weight 10;
- c3_5k_topology_heavy: 5000 pods on 500 types, half with a zone spread,
  half with hostname anti-affinity, under one NodePool of three zones;
- c5_50kx1k_mixed: 50000 pods of the headline's diverse mix on 1000 types
  (the KWOK offerings' spot and on-demand mix), one default NodePool.

`pods_realistic` is bench.py's c6 mix (chip_smoke.py's c6 phase; not a
BASELINE.json config).

    from karpenter_tpu_torch.testing import configs
    pools, ibp, pods, topo = configs.build("c3_5k_topology_heavy")
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Operator, Taint, TaintEffect, Toleration
from karpenter_tpu_torch.testing import fixtures


def build_universe(n_types: int):
    """The KWOK families x sizes, cut to n types (bench.py:119)."""
    return fixtures.kwok_universe(n_types)


def make_problem(n_pods: int, its, pods_fn: Optional[Callable] = None, pools_fn: Optional[Callable] = None):
    """(pools, instance types by pool, pods, Topology) from seed 42: one
    default NodePool and the diverse mix unless told otherwise
    (bench.py:132)."""
    from karpenter_tpu_torch.solver.topology import Topology

    fixtures.reset_rng(42)
    pools = pools_fn() if pools_fn else [fixtures.node_pool(name="default")]
    pods = pods_fn(n_pods) if pods_fn else fixtures.make_diverse_pods(n_pods)
    its_by_pool = {np.name: its for np in pools}
    return pools, its_by_pool, pods, Topology(pools, its_by_pool, pods)


def pods_requests_only(n: int) -> list:
    return fixtures.make_generic_pods(n)


def pods_selector_taints(n: int) -> list:
    """Generic pods, each pinned to one of four zones by a nodeSelector and
    tolerating the "team" taint."""
    zones = ["test-zone-a", "test-zone-b", "test-zone-c", "test-zone-d"]
    out = []
    for i, p in enumerate(fixtures.make_generic_pods(n)):
        p.node_selector = {well_known.TOPOLOGY_ZONE_LABEL_KEY: zones[i % 4]}
        p.tolerations = [Toleration(key="team", operator="Exists")]
        out.append(p)
    return out


def pools_tainted() -> list:
    return [
        fixtures.node_pool(name="default"),
        fixtures.node_pool(
            name="team",
            taints=[Taint(key="team", value="a", effect=TaintEffect.NO_SCHEDULE)],
            weight=10,
        ),
    ]


def pods_topology_heavy(n: int) -> list:
    """Half zone-spread pods, half hostname anti-affinity pods."""
    half = n // 2
    out = fixtures.make_topology_spread_pods(half, well_known.TOPOLOGY_ZONE_LABEL_KEY)
    out += fixtures.make_pod_anti_affinity_pods(n - half, well_known.HOSTNAME_LABEL_KEY)
    return out


def pools_three_zones() -> list:
    return [
        fixtures.node_pool(
            name="default",
            requirements=[
                NodeSelectorRequirement(
                    well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, ["test-zone-a", "test-zone-b", "test-zone-c"]
                )
            ],
        )
    ]


def pods_realistic(n: int) -> list:
    """The diverse mix plus a 2% tail of preference pods (the c6 mix)."""
    pods = fixtures.make_diverse_pods(int(n * 0.98))
    pods += fixtures.make_preference_pods(n - len(pods))
    return pods


class Config(NamedTuple):
    pods: int
    types: int
    pods_fn: Optional[Callable]
    pools_fn: Optional[Callable]


# BENCH_DETAIL.json's row names -> each config as bench.py builds it
CONFIGS = {
    "c1_500x50_requests_only": Config(500, 50, pods_requests_only, None),
    "c2_10kx500_selector_taints": Config(10_000, 500, pods_selector_taints, pools_tainted),
    "c3_5k_topology_heavy": Config(5_000, 500, pods_topology_heavy, pools_three_zones),
    "c5_50kx1k_mixed": Config(50_000, 1000, None, None),
}


def build(name: str, n_pods: Optional[int] = None, its=None):
    """A config's problem, (pools, instance types by pool, pods, Topology):
    at its own pod count and catalog unless `n_pods` or `its` is given."""
    cfg = CONFIGS[name]
    its = build_universe(cfg.types) if its is None else its
    return make_problem(cfg.pods if n_pods is None else n_pods, its, cfg.pods_fn, cfg.pools_fn)
