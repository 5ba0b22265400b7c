"""TorchScheduler (plain versions on the CPU) against the JAX scheduler's
scan path and the oracle.

Every case is a wire payload that both packages decode on their own (the
port through `karpenter_tpu_torch.wire`). Both schedulers take the scan
path (`debug_force_scan`; tests/test_torch_runs.py covers the runs path).
The port's Results must equal `fuzz.solve_tpu(case, force_scan=True)`'s and
`fuzz.solve_oracle`'s under `fuzz.results_snapshot`, and its odometer must
equal the reference scheduler's.
"""

import os

import pytest

from karpenter_tpu import jaxsetup
from karpenter_tpu.api import codec as ref_codec
from karpenter_tpu.api import labels as well_known
from karpenter_tpu.cloudprovider.kwok import construct_instance_types
from karpenter_tpu.solver.service import encode_problem_dict
from karpenter_tpu.solver.tpu_problem import UnsupportedBySolver as RefUnsupported
from karpenter_tpu.testing import fixtures, fuzz
from karpenter_tpu_torch import wire
from karpenter_tpu_torch.api import codec
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.solver.tpu_problem import UnsupportedBySolver

# relax-free fuzz seeds the kernel supports (see tests/test_torch_step.py)
SEEDS = [7005, 7017, 7023, 7024, 7030, 7031, 7037, 7055]
CORPUS = fuzz.load_corpus(os.path.join(os.path.dirname(__file__), "fuzz_corpus"))


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


def solve_torch(case: fuzz.FuzzCase, claim_slot_div=None):
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    if claim_slot_div is not None:
        options.claim_slot_div = claim_slot_div
    topo = Topology(
        pools, ibp, pods, cluster=source, state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    sched = TorchScheduler(pools, ibp, topo, views, daemons, options, device="cpu")
    sched.debug_force_scan = True
    return sched.solve(pods), pods, sched


def _three_way(case: fuzz.FuzzCase, claim_slot_div=None):
    want, pods_o = fuzz.solve_oracle(case)
    ref, pods_r, ref_sched = fuzz.solve_tpu(case, force_scan=True, claim_slot_div=claim_slot_div)
    got, pods_t, sched = solve_torch(case, claim_slot_div)
    want_snap = fuzz.results_snapshot(want, pods_o)
    assert fuzz.results_snapshot(ref, pods_r) == want_snap
    assert fuzz.results_snapshot(got, pods_t) == want_snap
    for key in ("steps", "bulk_steps", "dispatches", "overflow_signals", "regrows", "claims_opened", "claim_slots"):
        assert sched.last_odometer[key] == ref_sched.last_odometer[key], key
    return sched


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_seed_three_way(seed):
    _three_way(fuzz.generate_case(seed))


@pytest.mark.parametrize("name,entry", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_case(name, entry):
    """Pinned corpus cases: three-way equal, or both schedulers refuse the
    problem at encode time with the same reason."""
    case = fuzz.corpus_case(entry)
    try:
        fuzz.solve_tpu(case, force_scan=True)
    except RefUnsupported as e:
        with pytest.raises(UnsupportedBySolver) as got:
            solve_torch(case)
        assert str(got.value) == str(e)
        return
    _three_way(case)


def test_tight_slots_resolve_on_overflow():
    """80 hostname anti-affinity pods need 80 claims; the scan path starts
    with 64 slots, overflows, doubles N and re-solves — like the reference."""
    fixtures.reset_rng(11)
    pools = [fixtures.node_pool(name="default")]
    pods = fixtures.make_pod_anti_affinity_pods(80, well_known.HOSTNAME_LABEL_KEY)
    its = construct_instance_types(sizes=[2, 8])
    case = fuzz.FuzzCase(seed=0, families=["anti_affinity"], problem=encode_problem_dict(pools, {"default": its}, pods))
    sched = _three_way(case, claim_slot_div=10_000)
    assert sched.last_odometer["overflow_signals"] >= 1
    assert sched.last_odometer["regrows"] == 0  # the scan path re-solves
    assert sched.last_odometer["claim_slots"] == 128


@pytest.mark.parametrize("seed", [7005, 7030])
def test_wire_decode_matches_reference(seed):
    """The port decodes a payload into the same world the reference does."""
    case = fuzz.generate_case(seed)
    r_pools, r_ibp, r_pods, r_views, r_daemons, r_opts, _ = case.materialize()
    pools, ibp, pods, views, daemons, opts, _force, _src = wire._decode_problem_dict(case.problem)
    assert [(p.uid, p.name, p.metadata.creation_timestamp) for p in pods] == [
        (p.uid, p.name, p.metadata.creation_timestamp) for p in r_pods
    ]
    assert codec.to_jsonable(pods) == ref_codec.to_jsonable(r_pods)
    assert codec.to_jsonable(pools) == ref_codec.to_jsonable(r_pools)
    assert {k: codec.to_jsonable(list(v)) for k, v in ibp.items()} == {
        k: ref_codec.to_jsonable(list(v)) for k, v in r_ibp.items()
    }
    assert [v.name for v in views or []] == [v.name for v in r_views or []]
    assert vars(opts) == vars(r_opts)
