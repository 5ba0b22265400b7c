"""The BASELINE.json configs: the port's makers (`karpenter_tpu_torch
.testing.configs`) against bench.py's, and small solves of each config's
shape through the port's `TorchScheduler(device="cpu")` against the JAX
package's `TpuScheduler`, on the CPU.

- (a) the makers give the same pods and NodePools, object by object (the
  objects' JSON through each package's codec, uids aside): c1 and c3 at
  their full pod counts, c2 and c5 at 2000 pods;
- (b) each config's shape at a small size (c1 in full; c2 and c3 at 300
  pods on 500 types; c5 at 300 pods on its 1000 types): the decisions'
  digest (`fuzz.snapshot_digest`), the odometer and the route equal;
- (c) c3's shape at 300 pods regrows its claim slots twice;
- (d) `snapshot_digest` of both packages' snapshots of one solve agree, and
  numpy and Python ints digest alike.

The full widths run on the card (chip_smoke.py's baseline configs phase,
held to digests that `tools/reference_configs.py` records).
"""

import os

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu import jaxsetup
from karpenter_tpu.api import codec as rcodec
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.testing import fuzz
from karpenter_tpu_torch.api import codec as pcodec
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.testing import configs
from karpenter_tpu_torch.testing import fuzz as pfuzz

# config -> (bench.py's pod maker, its pool maker), as bench.py --all builds it
BENCH = {
    "c1_500x50_requests_only": (bench.pods_requests_only, None),
    "c2_10kx500_selector_taints": (bench.pods_selector_taints, bench.pools_tainted),
    "c3_5k_topology_heavy": (bench.pods_topology_heavy, bench.pools_three_zones),
    "c5_50kx1k_mixed": (None, None),
}
# (a): the pod counts the makers are compared at
MAKER_PODS = {
    "c1_500x50_requests_only": 500,
    "c2_10kx500_selector_taints": 2000,
    "c3_5k_topology_heavy": 5000,
    "c5_50kx1k_mixed": 2000,
}
# (b): the pod counts of the small solves, each on its config's own catalog
SOLVE_PODS = {
    "c1_500x50_requests_only": 500,
    "c2_10kx500_selector_taints": 300,
    "c3_5k_topology_heavy": 300,
    "c5_50kx1k_mixed": 300,
}
ODOMETER_KEYS = ("steps", "bulk_steps", "tier_steps", "tier_hist", "dispatches", "overflow_signals", "regrows",
                 "claims_opened", "claim_slots")


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    """The reference side compiles without the persistent XLA cache (its
    cache writes have crashed workers); the setting is restored after."""
    old = os.environ.get("KARPENTER_COMPILATION_CACHE_DIR")
    os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""
    jaxsetup.ensure_compilation_cache()
    yield
    if old is None:
        del os.environ["KARPENTER_COMPILATION_CACHE_DIR"]
    else:
        os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = old
    jaxsetup.ensure_compilation_cache()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's plain walk on one intra-op thread: under `-n 6` each
    worker's full OpenMP pool spins against the others' (the c5 shape's
    solve took 15.8 s alone and 235.9 s beside five such workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _view(codec, obj) -> dict:
    """An object's JSON through its package's codec, without the uids the
    packages draw from their own counters."""
    d = codec.to_jsonable(obj)
    d["metadata"].pop("uid")
    return d


def _reference(name: str, n_pods: int):
    pods_fn, pools_fn = BENCH[name]
    return bench.make_problem(n_pods, bench.build_universe(configs.CONFIGS[name].types), pods_fn, pools_fn)


def test_configs_table_matches_bench():
    """Each config's pod count and catalog are bench.py --all's (bench.py:957-1040)."""
    assert {k: (c.pods, c.types) for k, c in configs.CONFIGS.items()} == {
        "c1_500x50_requests_only": (500, 50),
        "c2_10kx500_selector_taints": (10_000, 500),
        "c3_5k_topology_heavy": (5_000, 500),
        "c5_50kx1k_mixed": (50_000, 1000),
    }
    for name, (pods_fn, pools_fn) in BENCH.items():
        cfg = configs.CONFIGS[name]
        assert (cfg.pods_fn is None) == (pods_fn is None) and (cfg.pools_fn is None) == (pools_fn is None)
        assert cfg.pods_fn is None or cfg.pods_fn.__name__ == pods_fn.__name__
        assert cfg.pools_fn is None or cfg.pools_fn.__name__ == pools_fn.__name__


@pytest.mark.parametrize("name", sorted(MAKER_PODS))
def test_makers_match_bench(name):
    n = MAKER_PODS[name]
    pools, ibp, pods, _topo = _reference(name, n)
    ppools, pibp, ppods, _ptopo = configs.build(name, n_pods=n)
    assert len(ppods) == len(pods) == n
    for a, b in zip(pods, ppods):
        assert _view(rcodec, a) == _view(pcodec, b), a.name
    assert [_view(rcodec, p) for p in pools] == [_view(pcodec, p) for p in ppools]
    assert sorted(ibp) == sorted(pibp)
    for pool in ibp:
        assert [it.name for it in ibp[pool]] == [it.name for it in pibp[pool]]
        assert len(ibp[pool]) == configs.CONFIGS[name].types
        # every offering alike: zone, capacity type, price, availability
        assert [[(o.zone(), o.capacity_type(), o.price, o.available) for o in it.offerings] for it in ibp[pool]] == [
            [(o.zone(), o.capacity_type(), o.price, o.available) for o in it.offerings] for it in pibp[pool]
        ]


def test_realistic_mix_matches_bench():
    """`pods_realistic` (the c6 mix, run by chip_smoke.py's c6 phase) is
    bench.py's, and `fixtures.c6_pods`."""
    from karpenter_tpu.testing import fixtures as rfixtures
    from karpenter_tpu_torch.testing import fixtures as pfixtures

    rfixtures.reset_rng(42)
    want = [_view(rcodec, p) for p in bench.pods_realistic(2000)]
    pfixtures.reset_rng(42)
    assert [_view(pcodec, p) for p in configs.pods_realistic(2000)] == want
    assert [_view(pcodec, p) for p in pfixtures.c6_pods(2000)] == want


def _reference_solve(name: str, n: int):
    pools, ibp, pods, topo = _reference(name, n)
    sched = TpuScheduler(pools, ibp, topo)
    res = sched.solve(pods)
    return sched, res, pods


def _port_solve(name: str, n: int):
    pools, ibp, pods, topo = configs.build(name, n_pods=n)
    sched = TorchScheduler(pools, ibp, topo, device="cpu")
    res = sched.solve(pods)
    return sched, res, pods


@pytest.mark.parametrize("name", sorted(SOLVE_PODS))
def test_small_solve_matches_reference(name):
    n = SOLVE_PODS[name]
    rs, rres, rpods = _reference_solve(name, n)
    ps, pres, ppods = _port_solve(name, n)
    assert (ps.last_used_runs, ps.last_relax) == (rs.last_used_runs, rs.last_relax)
    assert {k: ps.last_odometer[k] for k in ODOMETER_KEYS} == {k: rs.last_odometer[k] for k in ODOMETER_KEYS}
    want = pfuzz.snapshot_digest(fuzz.results_snapshot(rres, rpods))
    assert pfuzz.snapshot_digest(pfuzz.results_snapshot(pres, ppods)) == want
    assert not pres.pod_errors
    assert sum(len(c.pods) for c in pres.new_node_claims) == n
    if name == "c3_5k_topology_heavy":
        # (c): the card's full-width c3 regrows three times; this shape twice
        assert ps.last_odometer["regrows"] >= 2


def test_digest_agrees_across_packages():
    """(d): one JAX solve's snapshot through the JAX package's and the
    port's `results_snapshot` gives one digest, and it moves with the
    decisions."""
    rs, rres, rpods = _reference_solve("c1_500x50_requests_only", 40)
    snap = fuzz.results_snapshot(rres, rpods)
    digest = pfuzz.snapshot_digest(snap)
    assert digest == pfuzz.snapshot_digest(pfuzz.results_snapshot(rres, rpods))
    assert len(digest) == 64 and int(digest, 16) >= 0
    claims, existing, errors, timed_out = snap
    assert pfuzz.snapshot_digest((claims[1:], existing, errors, timed_out)) != digest
    assert pfuzz.snapshot_digest((claims, existing, errors, not timed_out)) != digest


def test_digest_is_canonical_over_number_types():
    """numpy ints and Python ints of one value digest alike; a fraction is
    refused rather than rounded."""
    a = ([(("p-0", "p-1"), "default", ("m5.large",), (("cpu", 1500), ("memory", 1 << 30)))], [], (), False)
    b = ([(("p-0", "p-1"), "default", ("m5.large",), (("cpu", np.int64(1500)), ("memory", np.int32(1 << 30))))],
         [], (), np.bool_(False).item())
    assert pfuzz.snapshot_digest(a) == pfuzz.snapshot_digest(b)
    with pytest.raises(ValueError):
        pfuzz.snapshot_digest(([(("p-0",), "default", (), (("cpu", 1.5),))], [], (), False))
