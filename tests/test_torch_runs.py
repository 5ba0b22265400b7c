"""The port's runs path against the JAX package's, on the CPU.

Inputs are built by the JAX package and carried over with
`karpenter_tpu_torch.convert` (byte-identical), or made from a numpy seed.
Every comparison is bit for bit:

- `run_arrays` (plain) against `tpu._run_arrays`;
- `solve_runs_plain` against `tpu_runs.solve_runs(relax=False)`: every
  output, the final State and the odometer's steps/bulk_steps;
- a mid-run claim-slot overflow, compared at the stop and then solved
  three ways (oracle, JAX runs path, the port) with a regrow;
- `dedup_rows` (plain) against `tpu._dedup_decode_state`;
- the port's runs path against its forced scan path.
"""

import os

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.cloudprovider.kwok import construct_instance_types
from karpenter_tpu.ops.encode import Reqs as JReqs
from karpenter_tpu.solver import tpu as JT
from karpenter_tpu.solver import tpu_kernel as JK
from karpenter_tpu.solver import tpu_runs as JR
from karpenter_tpu.solver.service import encode_problem_dict
from karpenter_tpu.solver.topology import Topology
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.solver.tpu_problem import _pow2, encode_problem
from karpenter_tpu.testing import fixtures, fuzz
from karpenter_tpu_torch import convert, wire
from karpenter_tpu_torch.solver import tpu as PT
from karpenter_tpu_torch.solver import tpu_kernel as PK
from karpenter_tpu_torch.solver import tpu_runs as PR
from karpenter_tpu_torch.solver.topology import Topology as PTopology

# relax-free fuzz seeds on which the reference takes the runs path
SEEDS = [7005, 7006, 7009, 7012, 7023, 7025, 7026, 7032]


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


def _diverse_case(n_pods: int, seed: int = 5) -> fuzz.FuzzCase:
    """The headline mix (five equal classes) at a small size."""
    fixtures.reset_rng(seed)
    pools = [fixtures.node_pool(name="default")]
    pods = fixtures.make_diverse_pods(n_pods)
    its = construct_instance_types(sizes=[2, 8, 32])
    return fuzz.FuzzCase(seed=0, families=["diverse"], problem=encode_problem_dict(pools, {"default": its}, pods))


def _run_inputs(case: fuzz.FuzzCase, claim_slot_div=None):
    """The JAX scheduler's first runs-path dispatch of a case: (tb, st,
    rx, n, scheduler, problem)."""
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    if claim_slot_div is not None:
        options.claim_slot_div = claim_slot_div
    topo = Topology(
        pools, ibp, pods, cluster=source, state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    s = TpuScheduler(pools, ibp, topo, views, daemons, options)
    p = encode_problem(s.oracle, pods)
    assert not (p.ntiers_r > 1).any()
    order = s._order_pods(p)
    tb = s._tables(p)
    s._upload_pod_tables(p)
    s._bulk_flags_c = JT._bulk_class_flags(p, JT._bulk_gates(p, strict_types=False))
    assert s._bulk_flags_c.any()
    s._set_runflags_dev()
    div = max(1, int(options.claim_slot_div))
    N = min(_pow2(max(64, (len(pods) + div - 1) // div)), _pow2(len(pods)))
    xs, idx_d, n_d = s._pod_xs_with_idx(p, order)
    return tb, s._init_state(p, N), s._run_x(xs, idx_d, n_d), len(order), s, p


def _assert_states_equal(want, got):
    for name, a, b in zip(PK.State._fields, want, got):
        if isinstance(a, tuple):
            for f, x, y in zip(a._fields, a, b):
                assert torch.equal(x, y), f"{name}.{f}"
        else:
            assert torch.equal(a, b), name


def _check_runs(tb, st, rx, n):
    """Both solve_runs on the same inputs; returns the port's outputs."""
    N = st.active.shape[0]
    jout = jax.device_get(
        JR.solve_runs(tb, st, rx, jax.numpy.zeros(N, jax.numpy.int32), jax.numpy.int32(0), jax.numpy.int32(n), relax=False)
    )
    tb_n, st_n, rx_n = jax.device_get((tb, st, rx))
    pout = PR.solve_runs_plain(
        convert.tables(tb_n), convert.state(st_n), convert.run_x(rx_n),
        torch.zeros(N, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), n,
    )
    jst, jseq, jnseq, jkinds, jslots, jover, jodo, jptr = jout
    pst, pseq, pnseq, pkinds, pslots, pover, podo, pptr = pout
    assert np.array_equal(np.asarray(jkinds), pkinds.numpy())
    assert np.array_equal(np.asarray(jslots), pslots.numpy())
    assert np.array_equal(np.asarray(jseq), pseq.numpy())
    assert int(jnseq) == int(pnseq)
    assert bool(jover) == bool(pover)
    assert int(jptr) == int(pptr)
    assert int(jodo.steps) == int(podo.steps)
    assert int(jodo.bulk_steps) == int(podo.bulk_steps)
    _assert_states_equal(convert.state(jst), pst)
    return pout


@pytest.mark.parametrize("seed", [7000, 7005, 7012, 7017, 7018, 7024, 7030, 7031, 7032, 7042, 7055, "diverse"])
def test_bulk_flags_match_reference(seed):
    """The problem gates and per-class bulk flags (the runs-path choice),
    from each package's own encode of the same payload."""
    from karpenter_tpu_torch.solver.tpu_problem import encode_problem as p_encode

    case = _diverse_case(60) if seed == "diverse" else fuzz.generate_case(seed)
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    topo = Topology(pools, ibp, pods, cluster=source, state_node_views=views, ignore_preferences=options.ignore_preferences)
    p = encode_problem(TpuScheduler(pools, ibp, topo, views, daemons, options).oracle, pods)
    want = JT._bulk_class_flags(p, JT._bulk_gates(p, strict_types=False))
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    topo = PTopology(pools, ibp, pods, cluster=source, state_node_views=views, ignore_preferences=options.ignore_preferences)
    q = p_encode(PT.TorchScheduler(pools, ibp, topo, views, daemons, options, device="cpu").oracle, pods)
    assert PT._bulk_gates(q) == JT._bulk_gates(p, strict_types=False)
    assert np.array_equal(PT._bulk_class_flags(q, PT._bulk_gates(q)), want)


@pytest.mark.parametrize(
    "P,n,NC,layout",
    [
        (8, 8, 3, "runs"), (64, 41, 5, "runs"), (256, 200, 9, "runs"), (128, 1, 2, "runs"),
        (1, 0, 2, "runs"), (1, 1, 2, "runs"),  # a single position, padding or a pod
        (64, 0, 3, "runs"),  # every position padding
        (96, 96, 4, "runs"),  # no padding: the last run ends at P
        (100, 100, 3, "one run"),  # one run over every position
        (33, 20, 4, "runs"), (1025, 700, 9, "runs"),  # P not a multiple of 32
    ],
)
def test_run_arrays_match_reference(P, n, NC, layout):
    """Seeded class sequences with runs, singletons and pad positions."""
    rng = np.random.default_rng(20 + P + n)
    cls_d = rng.integers(0, NC, size=max(300, P)).astype(np.int32)
    cls_d.sort()  # runs of equal classes, as the FFD order makes them
    idx = np.zeros(P, np.int32)
    if layout == "one run":
        idx[:n] = 7
    else:
        idx[:n] = np.sort(rng.choice(cls_d.shape[0], size=n, replace=False))
    bulk_c = rng.random(NC) < 0.6
    aff_c = rng.random(NC) < 0.3
    want = jax.device_get(JT._run_arrays(cls_d, bulk_c, aff_c, idx, np.int32(n)))
    got = PT.run_arrays_plain(
        torch.from_numpy(cls_d), torch.from_numpy(bulk_c), torch.from_numpy(aff_c), torch.from_numpy(idx), n
    )
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    if layout == "one run" and n == P:
        assert np.array_equal(got[3].numpy(), P - np.arange(P))  # the run ends at P


def test_run_arrays_outputs_share_one_buffer():
    """The CUDA wrapper's four outputs are views of one buffer laid out as
    csrc/run_arrays.cu writes it: run_rem (int32) first, then is_head, bulk
    and aff (one byte each a position)."""
    for P in (1, 33, 16384):
        out, (is_head, bulk, aff, run_rem) = PT._run_arrays_out(P, torch.device("cpu"))
        assert out.dtype == torch.bool and out.numel() == 7 * P
        base = out.data_ptr()
        assert run_rem.dtype == torch.int32 and run_rem.data_ptr() == base and run_rem.shape == (P,)
        for j, t in enumerate((is_head, bulk, aff)):
            assert t.dtype == torch.bool and t.shape == (P,) and t.is_contiguous()
            assert t.data_ptr() == base + (4 + j) * P


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_runs_matches_reference(seed):
    tb, st, rx, n, _, _ = _run_inputs(fuzz.generate_case(seed))
    _check_runs(tb, st, rx, n)


def test_derive_rank_matches_reference():
    tb, st, rx, n, _, _ = _run_inputs(fuzz.generate_case(7032))
    N = st.active.shape[0]
    jst, jseq = jax.device_get(
        JR.solve_runs(tb, st, rx, jax.numpy.zeros(N, jax.numpy.int32), jax.numpy.int32(0), jax.numpy.int32(n), relax=False)[:2]
    )
    want = np.asarray(JR._derive_rank(jst, jseq))
    assert np.array_equal(want, PR._derive_rank(convert.state(jst), torch.from_numpy(np.array(jseq))).numpy())


def test_mid_run_overflow_stops_like_reference():
    """64 claim slots for a mix that opens more: both walks stop on the
    same pod with identical partial state."""
    tb, st, rx, n, _, _ = _run_inputs(_diverse_case(400), claim_slot_div=10_000)
    assert st.active.shape[0] == 64
    out = _check_runs(tb, st, rx, n)
    assert bool(out[5]) and 0 < int(out[7]) < n


def _solve_port(case: fuzz.FuzzCase, claim_slot_div=None, force_scan=False):
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    if claim_slot_div is not None:
        options.claim_slot_div = claim_slot_div
    topo = PTopology(
        pools, ibp, pods, cluster=source, state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    sched = PT.TorchScheduler(pools, ibp, topo, views, daemons, options, device="cpu")
    sched.debug_force_scan = force_scan
    return sched.solve(pods), pods, sched


def test_regrow_three_way():
    """The overflow continuation: oracle, the JAX runs path and the port
    agree, and the port's odometer equals the JAX scheduler's."""
    case = _diverse_case(400)
    want, pods_o = fuzz.solve_oracle(case)
    ref, pods_r, ref_sched = fuzz.solve_tpu(case, claim_slot_div=10_000)
    got, pods_t, sched = _solve_port(case, claim_slot_div=10_000)
    assert ref_sched.last_used_runs and sched.last_used_runs
    want_snap = fuzz.results_snapshot(want, pods_o)
    assert fuzz.results_snapshot(ref, pods_r) == want_snap
    assert fuzz.results_snapshot(got, pods_t) == want_snap
    for key in ("steps", "bulk_steps", "dispatches", "overflow_signals", "regrows", "claims_opened", "claim_slots"):
        assert sched.last_odometer[key] == ref_sched.last_odometer[key], key
    assert sched.last_odometer["regrows"] >= 1


def _synthetic_rows(seed: int, n: int, C: int) -> np.ndarray:
    """Rows drawn from a small pool, so most are duplicates; words span
    the whole u32 range."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, size=(max(2, n // 8), C), dtype=np.uint64).astype(np.uint32)
    return pool[rng.integers(0, pool.shape[0], size=n)]


@pytest.mark.parametrize("seed", [7005, 7032, "diverse"])
def test_dedup_matches_reference_on_final_state(seed):
    case = _diverse_case(300) if seed == "diverse" else fuzz.generate_case(seed)
    tb, st, rx, n, _, _ = _run_inputs(case)
    N = st.active.shape[0]
    jst = jax.device_get(
        JR.solve_runs(tb, st, rx, jax.numpy.zeros(N, jax.numpy.int32), jax.numpy.int32(0), jax.numpy.int32(n), relax=False)[0]
    )
    n2 = min(_pow2(max(int(jst.n_claims), 1), floor=64), N)
    small, compact = jax.device_get(JT._dedup_decode_state(jst, n2=n2, ecols=st.eavail.shape[0] + n2))
    n_uniq, inv = int(small[0]), np.asarray(small[1])
    got_n, got_inv, got_compact = PT.dedup_decode_state(convert.state(jst), n2)
    assert int(got_n) == n_uniq
    assert np.array_equal(inv, got_inv.numpy())
    assert np.array_equal(np.asarray(compact), got_compact.numpy().view(np.uint32))


@pytest.mark.parametrize("n,C", [(64, 5), (300, 184), (2048, 40)])
def test_dedup_matches_reference_on_synthetic_rows(n, C):
    rows = _synthetic_rows(n, n, C)
    # the reference's kernel body on bare rows: a State whose alive words
    # are the rows and whose requirement fields are empty
    r0 = lambda w: np.zeros((n, w), np.uint32)
    b0 = lambda: np.zeros((n, 0), bool)
    i0 = lambda: np.zeros((n, 0), np.int32)
    st = JK.State(
        active=None, count=None, rank=None, tmpl=np.zeros(n, np.int32),
        creq=JReqs(r0(0), r0(0), b0(), b0(), b0(), i0(), i0(), i0()),
        crequests=np.zeros((n, 1), np.int32), alive=rows, cmax_alloc=None, n_claims=None,
        ereq=JReqs(r0(0)[:0], r0(0)[:0], b0()[:0], b0()[:0], b0()[:0], i0()[:0], i0()[:0], i0()[:0]),
        eavail=np.zeros((0, 1), np.int32), trem=np.zeros((1, 1), np.int32),
        v_cnt=np.zeros((1, 1), np.int32), h_cnt=np.zeros((1, n), np.int32), rescap=None, held=None, hp_used=None,
    )
    small, compact = jax.device_get(JT._dedup_decode_state(st, n2=n, ecols=n))
    got_n, got_inv, got_compact = PT.dedup_rows_plain(torch.from_numpy(rows.view(np.int32)))
    assert int(got_n) == int(small[0]) and int(got_n) < n
    assert np.array_equal(np.asarray(small[1]), got_inv.numpy())
    assert np.array_equal(np.asarray(compact), got_compact.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_runs_path_equals_forced_scan(seed, monkeypatch):
    """The port's runs path (with the dedup decode forced on) and its
    forced scan path make the same decisions, and the oracle and the
    reference's runs path agree."""
    case = fuzz.generate_case(seed)
    monkeypatch.setattr(PT, "_DEDUP_DECODE_MIN", 64)
    runs, pods_r, sched_r = _solve_port(case)
    scan, pods_s, sched_s = _solve_port(case, force_scan=True)
    assert sched_r.last_used_runs and not sched_s.last_used_runs
    got = fuzz.results_snapshot(runs, pods_r)
    assert got == fuzz.results_snapshot(scan, pods_s)
    want, pods_o = fuzz.solve_oracle(case)
    assert got == fuzz.results_snapshot(want, pods_o)
    ref, pods_j, ref_sched = fuzz.solve_tpu(case)
    assert ref_sched.last_used_runs
    assert got == fuzz.results_snapshot(ref, pods_j)
    for key in ("steps", "bulk_steps", "regrows"):
        assert sched_r.last_odometer[key] == ref_sched.last_odometer[key], key
