"""The runs walk's stall fix and progress guard (solver/tpu_runs.py,
csrc/run_step.cu), on the CPU through the plain walk.

A bulk run head whose bulk step commits nothing (a lone feasible claim
that holds none of the run, `case_solo`, or a level whose every target
fails its exact verify, `case_level`) excludes the claims it tried and is
retried at the same pod. The walk used to rebuild the run cache at every
arrival at a head, which dropped the exclusion, so it took the same step
forever; the reference's walk still does, so the JAX package is not run
on these cases (only on a runs-path problem that never retries). The port
builds the cache once per head, and a guard ends any walk that makes more
than N + 1 steps in a row without committing a pod; the host raises
`RunsStallError`, which the hybrid guard degrades to the oracle. Every test here has a hard timeout: a walk that spins again
fails its test instead of hanging the run (each takes seconds; the budget
is wide for a loaded host).
"""

from __future__ import annotations

import pytest
import torch

from karpenter_tpu.testing import fuzz as jfuzz
from karpenter_tpu_torch import wire
from karpenter_tpu_torch.solver import hybrid
from karpenter_tpu_torch.solver import tpu_kernel as K
from karpenter_tpu_torch.solver import tpu_runs as KR
from karpenter_tpu_torch.solver.hybrid import solve_in_process
from karpenter_tpu_torch.testing import fixtures, fuzz


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain walk is a chain of small tensor ops: one intra-op thread
    runs it faster than a full pool, and test processes that each hold a
    full OpenMP pool spin one another's threads (on 8 cores, six processes
    each solving test_runs_odometer_unchanged's problem with 8 threads ran
    past 5 minutes of CPU apiece, against 4-6 s each with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(case: fuzz.FuzzCase, force_oracle: bool = False):
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    r, h = solve_in_process(
        pools, ibp, pods, views, daemons, options, cluster=source, force_oracle=force_oracle, device="cpu"
    )
    return fuzz.results_snapshot(r, pods), h


def _idle_bulk_step(self, ptr):
    """A bulk step that counts itself and commits nothing."""
    self.steps += 1
    self.bulk_steps += 1
    return 0, False


def _head_idle_steps(case: fuzz.FuzzCase) -> list[int]:
    """The heads at which the walk's bulk step committed nothing without
    overflowing: where a walk that rebuilt its cache at every arrival
    would have spun (the shrink predicate)."""
    hits = []
    bulk_step = KR._Walk.bulk_step

    def witness(self, ptr):
        k, oflow = bulk_step(self, ptr)
        if k == 0 and not oflow and self.is_head[ptr]:
            hits.append(ptr)
        return k, oflow

    KR._Walk.bulk_step = witness
    try:
        _got, _pods, sched = fuzz.solve_tpu(case, device="cpu")
    finally:
        KR._Walk.bulk_step = bulk_step
    return hits if sched.last_used_runs else []


@pytest.mark.hard_timeout(300)
@pytest.mark.parametrize("shrunk", [False, True], ids=["c6_pods_50", "shrunk"])
def test_stall_case_solves_on_the_kernel_route(shrunk):
    case = fixtures.runs_stall_case(shrunk)
    got, h = _solve(case)
    want, ho = _solve(case, force_oracle=True)
    assert h.used_tpu and h.fallback_kind is None, h.fallback_reason
    assert h.tpu.last_used_runs
    assert not ho.used_tpu
    assert got == want


@pytest.mark.hard_timeout(300)
@pytest.mark.parametrize("shrunk", [False, True], ids=["c6_pods_50", "shrunk"])
def test_stall_case_retries_at_a_head(shrunk):
    """The pinned cases still make the zero-commit head step the fix is
    about (the predicate `fuzz.shrink` kept), at pod 1."""
    assert _head_idle_steps(fixtures.runs_stall_case(shrunk)) == [1]


@pytest.mark.hard_timeout(300)
def test_shrunk_case_is_minimal():
    """`fuzz.shrink` under the head-retry predicate left two pods, one
    feature and one pool of the c6 case; shrinking again removes nothing."""
    case = fixtures.runs_stall_case(shrunk=True)
    pools, _ibp, pods, views, daemons, _opts, _src = case.materialize()
    assert (len(pools), len(pods), views or [], daemons or []) == (1, 2, [], [])
    assert fuzz.case_size(case) == 4
    again = fuzz.shrink(case, lambda c: bool(_head_idle_steps(c)), max_evals=40)
    assert fuzz.case_size(again) == 4


@pytest.mark.hard_timeout(300)
def test_walk_that_never_commits_reaches_the_guard(monkeypatch):
    """A bulk step that never commits ends the plain walk after N + 2
    idle steps, with the stall counter set, no overflow and ptr on the
    pod."""
    case = fixtures.runs_stall_case(shrunk=True)
    monkeypatch.setattr(KR._Walk, "bulk_step", _idle_bulk_step)
    seen = {}
    solve_runs = KR.solve_runs

    def spy(tb, st, rx, seq, next_seq, n_valid, relax=False, prof=None):
        out = solve_runs(tb, st, rx, seq, next_seq, n_valid, relax, prof)
        seen.update(N=st.active.shape[0], out=out)
        return out

    monkeypatch.setattr(KR, "solve_runs", spy)
    with pytest.raises(KR.RunsStallError, match="stalled at pod"):
        fuzz.solve_tpu(case, device="cpu")
    out, N = seen["out"], seen["N"]
    status = out[5].tolist()
    over, ptr, stalled, odo = K.counter_fields(status)
    assert stalled and not over
    assert status[K.CNT_STALL] == 1 and ptr < 2
    # a single step a pod before the first bulk step, then N + 2 idle ones
    assert odo["steps"] - ptr == N + 2 and odo["bulk_steps"] == N + 2


@pytest.mark.hard_timeout(300)
def test_stall_degrades_to_the_oracle(monkeypatch):
    case = fixtures.runs_stall_case(shrunk=True)
    want, _ = _solve(case, force_oracle=True)
    monkeypatch.setattr(KR._Walk, "bulk_step", _idle_bulk_step)
    got, h = _solve(case)
    assert h.fallback_kind == "tpu_error" and not h.used_tpu
    assert "RunsStallError" in h.fallback_reason
    assert got == want


def test_stall_error_is_not_a_device_failure():
    assert not hybrid.device_failure(KR.RunsStallError("runs walk stalled at pod 1 of a 2-pod dispatch"))


@pytest.mark.hard_timeout(300)
def test_runs_odometer_unchanged():
    """A runs-path problem that never retries keeps its odometer: 300
    diverse pods on 500 KWOK types, one wire payload, through the JAX
    package's `TpuScheduler` and the port's entry point (238 steps, 181 of
    them bulk, in one dispatch on both)."""
    fixtures.reset_rng(42)
    pods = fixtures.make_diverse_pods(300)
    problem = wire.encode_problem_dict(
        [fixtures.node_pool(name="default")], {"default": fixtures.kwok_universe(500)}, pods
    )
    ref, ref_pods, ref_sched = jfuzz.solve_tpu(jfuzz.FuzzCase(seed=0, families=["diverse"], problem=problem))
    pools, ibp, pods, views, daemons, options, source = fuzz.FuzzCase(seed=0, problem=problem).materialize()
    options.tpu_min_pods = 0
    r, h = solve_in_process(pools, ibp, pods, views, daemons, options, cluster=source, device="cpu")
    assert ref_sched.last_used_runs and h.used_tpu and h.tpu.last_used_runs
    for key in ("steps", "bulk_steps", "dispatches", "overflow_signals", "regrows", "claims_opened", "claim_slots"):
        assert h.tpu.last_odometer[key] == ref_sched.last_odometer[key], key
    assert h.tpu.last_odometer["bulk_steps"] > 0
    assert fuzz.results_snapshot(r, pods) == jfuzz.results_snapshot(ref, ref_pods)


def test_counter_block_layout():
    """The plain walk's status block is K3's counter block: overflow,
    steps, bulk_steps, next_seq, ptr, tier_steps, the tier bins, then the
    stall counter."""
    hist = list(range(K.ODO_TIER_BINS))
    blk = K.counter_block(True, 9, 4, 33, 7, sum(hist), hist, False, "cpu")
    assert blk.dtype == torch.int32 and blk.shape == (K.N_COUNTERS,)
    over, ptr, stalled, odo = K.counter_fields(blk.tolist())
    assert (over, ptr, stalled) == (True, 7, False)
    assert odo == {"steps": 9, "bulk_steps": 4, "tier_steps": sum(hist), "tier_hist": hist}
    odo_t = K.counters_odometer(blk, "cpu")
    assert odo_t.tier_hist.tolist() == hist and int(odo_t.steps) == 9
