"""The port's fleet lanes (solver/fleet.py) against the JAX package.

Each case is an in-process twin of a reference case (tests/test_fleet.py,
tests/test_service_faults.py), with the port on the CPU (`device="cpu"`,
the plain versions):

- the lane core: `fleet.fleet_dispatch` over B=4 stacked lanes of scaled
  `prequests` equals the JAX `fleet.fleet_dispatch` bit for bit (kinds,
  slots, overflow, the whole State, the per-lane odometer), relax off and
  on;
- the coalesced window: N threads calling `TorchScheduler.solve` meet in
  one window, and each lane's decisions and odometer equal the JAX
  `TpuScheduler`'s solo solve, with one fleet dispatch per round;
- a one-lane window, a runs-path solve, a deadline-blown lane and an
  overflowing lane each take the reference's way out;
- the window key: `table_fingerprint` groups request profiles, not
  clusters, and both fingerprints equal the reference's hex digests.

Every thread join and barrier has a timeout, and a window's threads run
with a short switch interval.
"""

import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from karpenter_tpu import jaxsetup
from karpenter_tpu.cloudprovider.kwok import construct_instance_types as ref_types
from karpenter_tpu.solver import epochs as ref_epochs
from karpenter_tpu.solver import fleet as ref_fleet
from karpenter_tpu.solver.oracle import SchedulerOptions as RefOptions
from karpenter_tpu.solver.topology import Topology as RefTopology
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.solver.tpu import _pow2 as ref_pow2
from karpenter_tpu.solver.tpu_problem import encode_problem as ref_encode
from karpenter_tpu.testing import fixtures as ref_fixtures
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.solver import epochs, fleet
from karpenter_tpu_torch.solver import tpu_kernel as PK
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.solver.tpu_problem import encode_problem
from karpenter_tpu_torch.testing import fixtures

JOIN_SECONDS = 120.0
# multiples of 100m: request granularity feeds the resource-table scale,
# so these profiles share one table fingerprint (tests/test_fleet.py:97)
PROFILES = [f"{k}00m" for k in range(1, 9)]
ODO_KEYS = ("steps", "bulk_steps", "tier_steps", "tier_hist", "dispatches", "overflow_signals", "claims_opened")


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


def _ref_followers(n: int) -> list:
    """The reference twin of the port's `fixtures.make_follower_pods`."""
    from karpenter_tpu.api import labels as wk
    from karpenter_tpu.api.objects import LabelSelector, PodAffinityTerm, TopologySpreadConstraint, WhenUnsatisfiable

    labels = {"app": "follower"}
    spread = TopologySpreadConstraint(
        max_skew=1, topology_key=wk.TOPOLOGY_ZONE_LABEL_KEY, when_unsatisfiable=WhenUnsatisfiable.DO_NOT_SCHEDULE,
        label_selector=LabelSelector(match_labels=dict(labels)),
    )
    affinity = PodAffinityTerm(topology_key=wk.TOPOLOGY_ZONE_LABEL_KEY, label_selector=LabelSelector(match_labels={"app": "fleet"}))
    return [
        ref_fixtures.pod(name=f"follow-{i}", labels=dict(labels), requests={"cpu": "1"},
                         topology_spread_constraints=[spread], pod_requirements=[affinity])
        for i in range(n)
    ]


def _world(fx, types, cpu: str, n: int = 6, sizes=(2, 8), n_pref: int = 0, n_follow: int = 0):
    """One lane's problem, built by either package's fixtures: n
    self-spread pods (the scan path's fixture) at `cpu`, n_pref
    preference pods (relaxation ladders) from one seed, and n_follow pods
    that need a second round (`fixtures.make_follower_pods`)."""
    fx.reset_rng(5)
    its = types(sizes=list(sizes))
    pools = [fx.node_pool(name="default")]
    pods = fx.make_self_spread_pods(n, cpu) + fx.make_preference_pods(n_pref)
    if n_follow:
        pods += fixtures.make_follower_pods(n_follow) if fx is fixtures else _ref_followers(n_follow)
    return pools, {"default": its}, pods


def _snapshot(r, pods) -> tuple:
    name = {p.uid: p.name for p in pods}
    claims = sorted(
        (
            tuple(sorted(name[p.uid] for p in c.pods)),
            c.template.nodepool_name,
            tuple(sorted(it.name for it in c.instance_type_options)),
            tuple(sorted(c.requests.items())),
        )
        for c in r.new_node_claims
        if c.pods
    )
    return claims, tuple(sorted(name[u] for u in r.pod_errors)), bool(r.timed_out)


def _ref_solo(cpu: str, timeout=None, **kw):
    """The referee: the same problem through a fresh JAX TpuScheduler."""
    pools, ibp, pods = _world(ref_fixtures, ref_types, cpu, **kw)
    opts = RefOptions(timeout_seconds=timeout) if timeout else None
    sched = TpuScheduler(pools, ibp, RefTopology(pools, ibp, pods), options=opts)
    r = sched.solve(pods)
    assert not sched.last_used_runs, "the referee must ride the scan path"
    return _snapshot(r, pods), sched.last_odometer


def _port_sched(cpu: str, coalescer, timeout=None, **kw):
    pools, ibp, pods = _world(fixtures, construct_instance_types, cpu, **kw)
    opts = SchedulerOptions(timeout_seconds=timeout) if timeout else None
    return TorchScheduler(pools, ibp, Topology(pools, ibp, pods), options=opts, device="cpu", fleet=coalescer), pods


def _drive_window(profiles, coalescer, timeouts=None, **kw):
    """len(profiles) threads, each solving its profile through one
    TorchScheduler wired to `coalescer`, released together by a barrier;
    returns {profile: (snapshot, scheduler)}."""
    timeouts = timeouts or {}
    scheds = {cpu: _port_sched(cpu, coalescer, timeouts.get(cpu), **kw) for cpu in profiles}
    out, errors = {}, {}
    barrier = threading.Barrier(len(profiles))

    def lane(cpu):
        try:
            sched, pods = scheds[cpu]
            barrier.wait(timeout=JOIN_SECONDS)
            out[cpu] = (_snapshot(sched.solve(pods), pods), sched)
        except BaseException as e:
            errors[cpu] = e

    threads = [threading.Thread(target=lane, args=(cpu,), daemon=True) for cpu in profiles]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # frequent switches, so that a lost update to a shared count shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_SECONDS)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "a lane thread hung"
    assert not errors, errors
    return out


def _assert_odometer(got: dict, want: dict):
    for k in ODO_KEYS:
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# the lane core (tests/test_fleet.py:188)


def _preference_problem():
    """(tb, st, xs) of a small tiered problem on the reference side, in
    FFD order: preference ladders beside self-spread pods."""
    pools, ibp, pods = _world(ref_fixtures, ref_types, "200m", n=6, n_pref=6)
    sched = TpuScheduler(pools, ibp, RefTopology(pools, ibp, pods))
    problem = ref_encode(sched.oracle, pods)
    assert (problem.ntiers_r > 1).any()
    order = sched._order_pods(problem)
    tb = sched._tables(problem)
    sched._upload_pod_tables(problem)
    return tb, sched._init_state(problem, ref_pow2(len(pods))), sched._pod_xs(problem, order)


@pytest.mark.parametrize("relax", [False, True], ids=["diverse-relax-off", "preference-relax-on"])
def test_lane_core_matches_reference_fleet_dispatch(relax):
    if relax:
        tb, st, xs = _preference_problem()
    else:
        tb, st, xs, _, _ = graft._small_problem(n_pods=16)
    B = 4
    scale = 1 + (np.arange(B) % 3)
    xs_lanes = [xs._replace(prequests=xs.prequests * int(scale[k])) for k in range(B)]
    st_b, xs_b = ref_fleet.stack_lanes([st] * B, xs_lanes)
    want = jax.device_get(ref_fleet.fleet_dispatch(tb, st_b, xs_b, relax=relax, sharded=False))

    tb_n, st_n, xs_n = jax.device_get((tb, st, xs_lanes))
    p_st = convert.state(st_n)
    p_st = p_st._replace(n_claims=p_st.n_claims.reshape(()))  # convert makes 0-dim arrays 1-dim
    p_st_b, p_xs_b = fleet.stack_lanes([p_st] * B, [convert.pod_x(x) for x in xs_n])
    d0 = fleet.FLEET_DISPATCHES["fleet"]
    got = fleet.fleet_dispatch(convert.tables(tb_n), p_st_b, p_xs_b, relax)
    assert fleet.FLEET_DISPATCHES["fleet"] - d0 == 1

    w_st, w_kinds, w_slots, w_over, w_odo = want
    g_st, g_kinds, g_slots, g_over, g_odo = got
    assert np.array_equal(g_kinds.numpy(), np.asarray(w_kinds))
    assert np.array_equal(g_slots.numpy(), np.asarray(w_slots))
    assert np.array_equal(g_over.numpy(), np.asarray(w_over))
    assert np.array_equal(g_st.n_claims.numpy(), np.asarray(w_st.n_claims))
    for f in PK.Odometer._fields:
        assert np.array_equal(getattr(g_odo, f).numpy(), np.asarray(getattr(w_odo, f))), f
    for name, a, b in zip(PK.State._fields, convert.state(w_st), g_st):
        pairs = zip(a._fields, a, b) if isinstance(a, tuple) else [("", a, b)]
        for f, x, y in pairs:
            assert torch.equal(x, y), f"{name}.{f}"
    # each lane committed its own requests, and relax on ran the tier loop
    assert len({g_st.crequests[k].numpy().tobytes() for k in range(B)}) == len(set(scale.tolist()))
    assert bool(relax) == bool(np.asarray(w_odo.tier_steps).sum())


# ---------------------------------------------------------------------------
# the coalesced window (tests/test_fleet.py:107)


@pytest.mark.parametrize("lanes,n_pref", [(2, 0), (5, 0), (8, 0), (3, 4)], ids=["2", "5", "8", "3-relax"])
def test_coalesced_window_matches_reference_solo(lanes, n_pref):
    """`lanes` concurrent solves (with n_pref preference pods each: the
    tier loop on every lane's rows) meet in one window; each lane equals
    its solo solve, with one shared dispatch per round."""
    profiles = PROFILES[:lanes]
    kw = dict(n=6, n_pref=n_pref)
    refs = {cpu: _ref_solo(cpu, **kw) for cpu in profiles}
    c0 = dict(fleet.FLEET_SOLVES)
    d0 = fleet.FLEET_DISPATCHES["fleet"]
    out = _drive_window(profiles, fleet.FleetCoalescer(window_seconds=10.0, max_lanes=lanes), **kw)
    rounds = set()
    for cpu in profiles:
        snap, sched = out[cpu]
        assert sched.last_used_fleet and not sched.last_used_runs, cpu
        assert sched.last_relax == bool(n_pref)
        assert snap == refs[cpu][0], cpu
        assert not snap[1] and snap[0], cpu
        _assert_odometer(sched.last_odometer, refs[cpu][1])
        assert bool(sched.last_odometer["tier_steps"]) == bool(n_pref)
        assert sched.last_fleet["mode"] == "coalesced" and sched.last_fleet["lanes"] == lanes
        rounds.add(sched.last_fleet["rounds"])
    assert fleet.FLEET_SOLVES["coalesced"] - c0["coalesced"] == lanes
    assert fleet.FLEET_SOLVES["solo_window"] == c0["solo_window"]
    assert fleet.FLEET_SOLVES["fallback"] == c0["fallback"]
    # one shared dispatch per round for the whole window, never per lane
    assert fleet.FLEET_DISPATCHES["fleet"] - d0 == max(rounds) >= 1


def test_requeued_window_matches_reference_solo():
    """A window whose lanes requeue: each lane's follower pods fail in the
    first round (no app=fleet pod is placed yet) and land in the second.
    Every lane is coalesced and equals its solo JAX solve (decisions and
    odometer), with one shared dispatch per round over at least two."""
    profiles = PROFILES[:3]
    kw = dict(n=6, n_follow=2)
    refs = {cpu: _ref_solo(cpu, **kw) for cpu in profiles}
    assert all(r[1]["dispatches"] >= 2 for r in refs.values())
    d0 = fleet.FLEET_DISPATCHES["fleet"]
    coalescer = fleet.FleetCoalescer(window_seconds=10.0, max_lanes=len(profiles))
    out = _drive_window(profiles, coalescer, **kw)
    for cpu in profiles:
        snap, sched = out[cpu]
        assert snap == refs[cpu][0], cpu
        assert not snap[1] and snap[0], cpu  # every follower placed
        _assert_odometer(sched.last_odometer, refs[cpu][1])
        assert sched.last_fleet["mode"] == "coalesced" and sched.last_fleet["rounds"] >= 2
    assert coalescer.last_window["rounds"] >= 2
    assert fleet.FLEET_DISPATCHES["fleet"] - d0 == coalescer.last_window["rounds"]


# ---------------------------------------------------------------------------
# the ways out of a window


def test_single_lane_window_falls_back_solo():
    """tests/test_fleet.py:225: a window that closes with one lane runs
    the solo path, counted as mode=solo_window."""
    ref = _ref_solo("100m")
    s0 = fleet.FLEET_SOLVES["solo_window"]
    sched, pods = _port_sched("100m", fleet.FleetCoalescer(window_seconds=0.05, max_lanes=8))
    assert _snapshot(sched.solve(pods), pods) == ref[0]
    assert not sched.last_used_fleet and sched.last_fleet["mode"] == "solo_window"
    _assert_odometer(sched.last_odometer, ref[1])
    assert fleet.FLEET_SOLVES["solo_window"] - s0 == 1


def test_runs_path_never_enters_the_coalescer():
    """tests/test_fleet.py:251: a bulkable (runs-path) solve solves
    identically with a coalescer wired and never touches its window."""

    def solve(fx, types, make_sched):
        fx.reset_rng(9)
        its = types(sizes=[2, 8])
        pools = [fx.node_pool(name="default")]
        pods = fx.make_generic_pods(8)
        sched = make_sched(pools, {"default": its}, pods)
        return sched, _snapshot(sched.solve(pods), pods)

    _, want = solve(ref_fixtures, ref_types, lambda p, i, pods: TpuScheduler(p, i, RefTopology(p, i, pods)))
    before = dict(fleet.FLEET_SOLVES)
    coalescer = fleet.FleetCoalescer(window_seconds=5.0)
    sched, got = solve(
        fixtures, construct_instance_types,
        lambda p, i, pods: TorchScheduler(p, i, Topology(p, i, pods), device="cpu", fleet=coalescer),
    )
    assert sched.last_used_runs and not sched.last_used_fleet and sched.last_fleet is None
    assert got == want
    assert fleet.FLEET_SOLVES == before


def test_deadline_blown_lane_times_out_while_siblings_match_solo():
    """tests/test_service_faults.py:1485: a lane whose budget is spent when
    the window drains comes back timed_out with no decisions, and its
    three siblings equal their solo solves in the same window."""
    healthy = ["100m", "200m", "300m"]
    refs = {cpu: _ref_solo(cpu) for cpu in healthy}
    blown_ref = _ref_solo("400m", timeout=1e-9)
    out = _drive_window(healthy + ["400m"], fleet.FleetCoalescer(window_seconds=10.0, max_lanes=4),
                        timeouts={"400m": 1e-9})
    snap, sched = out["400m"]
    assert snap == blown_ref[0]
    assert snap[2] and not snap[0], "timed out, no claim with pods"
    assert sched.last_used_fleet and sched.last_fleet["rounds"] == 0
    for cpu in healthy:
        snap, sched = out[cpu]
        assert sched.last_fleet["mode"] == "coalesced" and sched.last_fleet["lanes"] == 4
        assert snap == refs[cpu][0] and not snap[2], cpu


def test_overflowing_lane_goes_solo_with_equal_decisions():
    """80 pods start with 64 claim slots. A lane whose pods each need a
    node of their own overflows them: it leaves the window for the solo
    loop (N doubled) and equals its solo solve; its siblings stay
    coalesced."""
    kw = dict(n=80)
    profiles = ["100m", "200m", "4100m"]
    refs = {cpu: _ref_solo(cpu, **kw) for cpu in profiles}
    f0 = fleet.FLEET_SOLVES["fallback"]
    coalescer = fleet.FleetCoalescer(window_seconds=10.0, max_lanes=3)
    out = _drive_window(profiles, coalescer, **kw)
    snap, sched = out["4100m"]
    assert not sched.last_used_fleet and sched.last_fleet["mode"] == "fallback"
    assert sched.last_fleet["lanes"] == 3 and sched.last_fleet["rounds"] == 1
    assert snap == refs["4100m"][0] and len(snap[0]) > 64
    _assert_odometer(sched.last_odometer, refs["4100m"][1])
    assert sched.last_odometer["overflow_signals"] >= 1
    assert coalescer.last_fallback_error is None, "an overflow is no error"
    assert fleet.FLEET_SOLVES["fallback"] - f0 == 1
    for cpu in profiles[:2]:
        snap, sched = out[cpu]
        assert sched.last_used_fleet and snap == refs[cpu][0], cpu


def test_dispatch_fault_returns_every_lane_to_solo(monkeypatch):
    """A fault of the shared dispatch costs throughput, never an answer:
    every lane solves solo with its solo decisions, and the coalescer
    keeps the exception it caught."""
    profiles = PROFILES[:3]
    refs = {cpu: _ref_solo(cpu) for cpu in profiles}

    def broken(*args, **kwargs):
        raise RuntimeError("lane launch refused")

    monkeypatch.setattr(fleet.K, "solve_scan_lanes", broken)
    coalescer = fleet.FleetCoalescer(window_seconds=10.0, max_lanes=3)
    out = _drive_window(profiles, coalescer)
    for cpu in profiles:
        snap, sched = out[cpu]
        assert not sched.last_used_fleet and sched.last_fleet["mode"] == "fallback", cpu
        assert snap == refs[cpu][0], cpu
    assert "lane launch refused" in str(coalescer.last_fallback_error)


# ---------------------------------------------------------------------------
# the window key (tests/test_fleet.py:286)


def _fingerprints(cpu: str, sizes=(2, 8), n_pref: int = 0):
    """(port (table, problem), reference (table, problem)) fingerprints of
    one lane's problem."""
    out = []
    for fx, types, topo, sched_cls, encode in (
        (fixtures, construct_instance_types, Topology, lambda *a: TorchScheduler(*a, device="cpu"), encode_problem),
        (ref_fixtures, ref_types, RefTopology, TpuScheduler, ref_encode),
    ):
        pools, ibp, pods = _world(fx, types, cpu, sizes=sizes, n_pref=n_pref)
        problem = encode(sched_cls(pools, ibp, topo(pools, ibp, pods)).oracle, pods)
        mod = epochs if fx is fixtures else ref_epochs
        out.append((mod.table_fingerprint(problem), mod.problem_fingerprint(problem)))
    return out


def test_table_fingerprint_groups_profiles_not_clusters():
    (t1, p1), r1 = _fingerprints("100m")
    (t2, p2), r2 = _fingerprints("300m")
    (t3, p3), r3 = _fingerprints("100m", sizes=(2, 8, 32))
    (t4, p4), r4 = _fingerprints("4100m")
    (t5, p5), r5 = _fingerprints("200m", n_pref=4)
    # the port's digests are the reference's hex strings
    assert [(t1, p1), (t2, p2), (t3, p3), (t4, p4), (t5, p5)] == [r1, r2, r3, r4, r5]
    assert t1 == t2 == t4, "distinct request profiles must share a table key"
    assert len({p1, p2, p4}) == 3, "the full problem fingerprint must still differ"
    assert t1 != t3, "a different cluster must never share a table key"
    assert t5 not in (t1, t3), "relaxation tiers change the shared tables"
