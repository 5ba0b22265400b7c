"""The port's relax tier loop against the JAX package's, on the CPU.

A pod with a preference ladder (preferred node or pod (anti-)affinity,
ScheduleAnyway spreads, required node-affinity OR-terms) tries its tiers in
order inside its own step. Inputs are built by the JAX package and carried
over with `karpenter_tpu_torch.convert` (byte-identical). Every comparison is
bit for bit:

- (a) `solve_scan_plain(relax=True)` against `tpu_kernel.solve_scan(relax=True)`:
  kinds, slots, overflow, the final State and the odometer (tier_steps and
  tier_hist too), on preference rounds, tiered fuzz seeds and the traps
  (a tier that fails after the claim screen and verify loop ran, an
  overflow mid-ladder, invalid pad positions carrying a tiered pod's rows,
  single-tier pods beside tiered ones);
- (b) `solve_runs_plain(relax=True)` against `tpu_runs.solve_runs(relax=True)`,
  including a claim-slot overflow stop on a tiered pod;
- (c) the port's `_tier_typeok` against the reference's;
- (d) `TorchScheduler.solve` three ways (oracle, JAX, port) on tiered fuzz
  seeds: the natural path with the full odometer, forced scan, tight claim
  slots, and PreferencePolicy=Ignore;
- (e) scenarios of tests/test_relaxation_matrix.py as wire payloads.
"""

import os

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.api import labels as well_known
from karpenter_tpu.api.objects import (
    LabelSelector,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Operator,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    WhenUnsatisfiable,
)
from karpenter_tpu.cloudprovider.kwok import construct_instance_types
from karpenter_tpu.solver import tpu as JT
from karpenter_tpu.solver import tpu_kernel as JK
from karpenter_tpu.solver import tpu_runs as JR
from karpenter_tpu.solver.oracle import SchedulerOptions
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
from karpenter_tpu_torch.solver.tpu_problem import encode_problem as p_encode

ZONE = well_known.TOPOLOGY_ZONE_LABEL_KEY
HOSTNAME = well_known.HOSTNAME_LABEL_KEY

# kernel-supported fuzz seeds with relaxable classes, on the scan path:
# existing nodes + host ports + schedule-anyway (7000, 6 relaxable classes
# x 3 tiers), existing nodes (7003, 7016), limits + minValues + existing
# nodes (7034), reservations + 7 relaxable classes (7057)
SCAN_SEEDS = [7000, 7003, 7016, 7034, 7057]
# ... and on the runs path (a bulkable class beside the tiered ones)
RUNS_SEEDS = [7018, 7035, 7074, 7089]
# the three-way solves: both paths, existing nodes, PreferencePolicy=Ignore
# (7081, 7096), tight slots (7004, 7052)
THREE_WAY_SEEDS = [7000, 7004, 7016, 7035, 7052, 7057, 7081, 7089, 7096]


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


def _case(pools, its, pods, options=None) -> fuzz.FuzzCase:
    ibp = {p.name: its for p in pools}
    return fuzz.FuzzCase(seed=0, families=["relax"], problem=encode_problem_dict(pools, ibp, pods, options=options))


def _preference_case(n_pref: int, n_diverse: int, seed: int = 3) -> fuzz.FuzzCase:
    """Preference pods (every pod climbs a 4-tier ladder) first, so the
    batch's pad positions carry a tiered pod's rows, then the headline's
    single-tier classes."""
    fixtures.reset_rng(seed)
    pods = fixtures.make_preference_pods(n_pref) + fixtures.make_diverse_pods(n_diverse)
    return _case([fixtures.node_pool(name="default")], construct_instance_types(sizes=[2, 8]), pods)


def _min_values_case() -> fuzz.FuzzCase:
    """The trap of a tier that fails after its claim screen and verify loop
    ran: the pool wants 3 instance types per claim, and tier 0 of each
    "narrow" pod prefers exactly two. Tier 0 passes the claim's screens
    (compatible, fits, the pairwise type screen), fails the exact verify on
    minValues, and fails every template the same way; tier 1 drops the
    preference and joins the claim."""
    fixtures.reset_rng(21)
    its = construct_instance_types(sizes=[2, 8])
    pool = fixtures.node_pool(
        name="default",
        requirements=[NodeSelectorRequirement(well_known.INSTANCE_TYPE_LABEL_KEY, Operator.EXISTS, min_values=3)],
    )
    pods = [fixtures.pod(name=f"base-{i}", requests={"cpu": "300m"}) for i in range(4)]
    two = [its[0].name, its[4].name]
    for i in range(6):
        p = fixtures.pod(name=f"narrow-{i}", requests={"cpu": "100m"})
        p.node_affinity = NodeAffinity(
            preferred=[
                PreferredSchedulingTerm(
                    weight=5,
                    preference=NodeSelectorTerm(
                        match_expressions=[NodeSelectorRequirement(well_known.INSTANCE_TYPE_LABEL_KEY, Operator.IN, two)]
                    ),
                )
            ]
        )
        pods.append(p)
    return _case([pool], its, pods)


def _ref_scheduler(case: fuzz.FuzzCase, claim_slot_div=None):
    pools, ibp, pods, views, daemons, options, source = case.materialize()
    if claim_slot_div is not None:
        options.claim_slot_div = claim_slot_div
    topo = Topology(
        pools, ibp, pods, cluster=source, state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    s = TpuScheduler(pools, ibp, topo, views, daemons, options)
    p = encode_problem(s.oracle, pods)
    assert (p.ntiers_r > 1).any()
    return s, p, pods


def _scan_inputs(case: fuzz.FuzzCase, N=None):
    """The JAX scheduler's first scan-path round of a case: (tb, st, xs)."""
    s, p, pods = _ref_scheduler(case)
    order = s._order_pods(p)
    tb = s._tables(p)
    s._upload_pod_tables(p)
    if N is None:
        N = min(_pow2(max(64, (len(pods) + 3) // 4)), _pow2(len(pods)))
    return tb, s._init_state(p, N), s._pod_xs(p, order)


def _assert_states_equal(want, got):
    for name, a, b in zip(PK.State._fields, want, got):
        if isinstance(a, tuple):
            for f, x, y in zip(a._fields, a, b):
                assert torch.equal(x, y), f"{name}.{f}"
        else:
            assert torch.equal(a, b), name


def _assert_odometers_equal(jodo, podo):
    for f in ("steps", "bulk_steps", "tier_steps"):
        assert int(getattr(jodo, f)) == int(getattr(podo, f)), f
    assert np.asarray(jodo.tier_hist).tolist() == podo.tier_hist.tolist()


def _check_scan(tb, st, xs):
    """Both solve_scans with relax=True; returns the port's outputs."""
    jst, jkinds, jslots, jover, jodo = jax.device_get(JK.solve_scan(tb, st, xs, relax=True))
    tb_n, st_n, xs_n = jax.device_get((tb, st, xs))
    out = PK.solve_scan(convert.tables(tb_n), convert.state(st_n), convert.pod_x(xs_n), relax=True)
    pst, pkinds, pslots, pover, podo = out
    assert np.array_equal(np.asarray(jkinds), pkinds.numpy())
    assert np.array_equal(np.asarray(jslots), pslots.numpy())
    assert bool(jover) == bool(pover)
    _assert_odometers_equal(jodo, podo)
    _assert_states_equal(convert.state(jst), pst)
    return out


def _trips(tb, st, xs, stop_on_overflow=False):
    """Replay the port's plain tier loop pod by pod: [(kind, trips)] (up
    to and including the first overflow when asked)."""
    tb, st, xs = convert.tables(tb), convert.state(st), convert.pod_x(xs)
    out = []
    for p in range(xs.valid.shape[0]):
        x = PK.PodX(*(type(f)(*(a[p] for a in f)) if isinstance(f, tuple) else f[p] for f in xs))
        st, (kind, _, over), trips = PK._step_relax(tb, st, x)
        out.append((kind, trips))
        if over and stop_on_overflow:
            break
    return out


# ---------------------------------------------------------------------------
# (a) the scan path


@pytest.mark.parametrize("n_pref,n_diverse", [(16, 0), (20, 10), (40, 24)])
def test_preference_round_matches_reference(n_pref, n_diverse):
    tb, st, xs = jax.device_get(_scan_inputs(_preference_case(n_pref, n_diverse)))
    n = n_pref + n_diverse
    _, kinds, _, over, odo = _check_scan(tb, st, xs)
    assert not bool(over) and (kinds[:n] != PK.KIND_FAIL).all()
    assert int(odo.tier_steps) > n  # the preference pods climbed their ladders
    # invalid pad positions carry pod 0's rows (a tiered pod): one trip each
    pads = np.flatnonzero(~np.asarray(xs.valid))
    if len(pads):
        assert (np.asarray(xs.ntiers)[pads] > 1).all()
        steps = _trips(tb, st, xs)
        assert all(steps[i][1] == 1 for i in pads)


@pytest.mark.parametrize("seed", SCAN_SEEDS)
def test_fuzz_seed_scan_matches_reference(seed):
    _check_scan(*_scan_inputs(fuzz.generate_case(seed)))


def test_tier_fails_after_claim_screen_matches_reference():
    tb, st, xs = jax.device_get(_scan_inputs(_min_values_case()))
    _, kinds, _, _, _ = _check_scan(tb, st, xs)
    steps = _trips(tb, st, xs)
    # every narrow pod failed its tier 0 (the claim passed the screens and
    # failed the verify) and joined a claim at tier 1
    narrow = [i for i, v in enumerate(np.asarray(xs.ntiers)) if v > 1 and bool(xs.valid[i])]
    assert narrow and all(steps[i] == (PK.KIND_CLAIM, 2) for i in narrow)


def test_overflow_mid_ladder_matches_reference():
    """Two claim slots: a preference pod overflows at a tier past 0 (its
    tier 0 fails everywhere), and both packages report it the same way."""
    tb, st, xs = jax.device_get(_scan_inputs(_preference_case(24, 0), N=2))
    _, _, _, over, _ = _check_scan(tb, st, xs)
    assert bool(over)
    kind, trips = _trips(tb, st, xs, stop_on_overflow=True)[-1]
    assert kind == PK.KIND_FAIL and trips > 1


def test_relax_off_odometer_has_no_tier_trips():
    """relax=False on a single-tier problem: no tier counters (the plain
    step, as before the tier loop)."""
    tb, st, xs = jax.device_get(_scan_inputs(_preference_case(4, 6)))
    tb_p, st_p, xs_p = convert.tables(tb), convert.state(st), convert.pod_x(xs)
    single = xs_p._replace(ntiers=torch.ones_like(xs_p.ntiers))
    a = PK.solve_scan(tb_p, st_p, single, relax=True)
    b = PK.solve_scan(tb_p, st_p, single, relax=False)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    _assert_states_equal(a[0], b[0])
    assert int(b[4].tier_steps) == 0 and int(a[4].tier_steps) == xs_p.valid.shape[0]


# ---------------------------------------------------------------------------
# (b) the runs path


def _run_inputs(case: fuzz.FuzzCase, claim_slot_div=None):
    """The JAX scheduler's first runs-path dispatch: (tb, st, rx, n)."""
    s, p, pods = _ref_scheduler(case, claim_slot_div)
    order = s._order_pods(p)
    tb = s._tables(p)
    s._upload_pod_tables(p)
    s._bulk_flags_c = JT._bulk_class_flags(p, JT._bulk_gates(p, strict_types=False))
    assert s._bulk_flags_c.any()
    s._set_runflags_dev()
    div = max(1, int(s.opts.claim_slot_div))
    N = min(_pow2(max(64, (len(pods) + div - 1) // div)), _pow2(len(pods)))
    xs, idx_d, n_d = s._pod_xs_with_idx(p, order)
    return tb, s._init_state(p, N), s._run_x(xs, idx_d, n_d), len(order)


def _check_runs(tb, st, rx, n):
    N = st.active.shape[0]
    jout = jax.device_get(
        JR.solve_runs(tb, st, rx, jax.numpy.zeros(N, jax.numpy.int32), jax.numpy.int32(0), jax.numpy.int32(n), relax=True)
    )
    tb_n, st_n, rx_n = jax.device_get((tb, st, rx))
    pout = PR.solve_runs_plain(
        convert.tables(tb_n), convert.state(st_n), convert.run_x(rx_n),
        torch.zeros(N, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), n, relax=True,
    )
    jst, jseq, jnseq, jkinds, jslots, jover, jodo, jptr = jout
    pst, pseq, pnseq, pkinds, pslots, pover, podo, pptr = pout
    assert np.array_equal(np.asarray(jkinds), pkinds.numpy())
    assert np.array_equal(np.asarray(jslots), pslots.numpy())
    assert np.array_equal(np.asarray(jseq), pseq.numpy())
    assert int(jnseq) == int(pnseq)
    assert bool(jover) == bool(pover)
    assert int(jptr) == int(pptr)
    _assert_odometers_equal(jodo, podo)
    _assert_states_equal(convert.state(jst), pst)
    return pout


@pytest.mark.parametrize("seed", RUNS_SEEDS + ["mix"])
def test_solve_runs_relax_matches_reference(seed):
    case = _preference_case(12, 40, seed=5) if seed == "mix" else fuzz.generate_case(seed)
    out = _check_runs(*_run_inputs(case))
    assert int(out[6].bulk_steps) > 0 and int(out[6].tier_steps) > 0


def test_runs_overflow_on_tiered_pod_matches_reference():
    """64 claim slots for 80 "lonely" pods that each need a claim of their
    own (required hostname anti-affinity) and fail their tier 0 (an
    unsatisfiable zone preference), beside a bulkable class: the walk stops
    with ptr on the lonely pod that overflowed at tier 1, in both
    packages."""
    fixtures.reset_rng(8)
    pods = []
    for i in range(80):
        p = fixtures.pod(
            name=f"lonely-{i}",
            labels={"app": "lonely"},
            requests={"cpu": "1"},
            pod_anti_requirements=[
                PodAffinityTerm(topology_key=HOSTNAME, label_selector=LabelSelector(match_labels={"app": "lonely"}))
            ],
        )
        p.node_affinity = NodeAffinity(
            preferred=[
                PreferredSchedulingTerm(
                    weight=1,
                    preference=NodeSelectorTerm(
                        match_expressions=[NodeSelectorRequirement(ZONE, Operator.IN, ["no-such-zone"])]
                    ),
                )
            ]
        )
        pods.append(p)
    pods += [fixtures.pod(name=f"small-{i}", requests={"cpu": "100m"}) for i in range(40)]
    case = _case([fixtures.node_pool(name="default")], construct_instance_types(sizes=[2, 8]), pods)
    tb, st, rx, n = _run_inputs(case, claim_slot_div=10_000)
    assert st.active.shape[0] == 64
    out = _check_runs(tb, st, rx, n)
    ptr = int(out[7])
    assert bool(out[5]) and ptr == 64
    assert int(np.asarray(rx.x.ntiers)[ptr]) > 1


# ---------------------------------------------------------------------------
# (c) the tier type screen


@pytest.mark.parametrize("seed", [7000, 7034, 7057, "pref"])
def test_tier_typeok_matches_reference(seed):
    """NRx*L tier rows through the pairwise screen (7000: 6x3, 7034: 3x2,
    7057: 7x2 rows, none a power of two; pref: 1x4)."""
    case = _preference_case(8, 4) if seed == "pref" else fuzz.generate_case(seed)
    s, p, _ = _ref_scheduler(case)
    tb = s._tables(p)
    want = np.asarray(jax.device_get(tb.rt_typeok))
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    topo = PTopology(pools, ibp, pods, cluster=source, state_node_views=views, ignore_preferences=options.ignore_preferences)
    sched = PT.TorchScheduler(pools, ibp, topo, views, daemons, options, device="cpu")
    q = p_encode(sched.oracle, pods)
    got = sched._tables(q).rt_typeok
    assert np.array_equal(want, got.numpy().view(np.uint32))
    NRx, L = len(q.rt_tier_reqs), q.num_tiers
    if seed != "pref":
        assert NRx * L & (NRx * L - 1)  # not a power of two: the padding path
    assert (got[:NRx] != 0).any()


# ---------------------------------------------------------------------------
# (d) the scheduler, three ways


def _solve_port(case: fuzz.FuzzCase, claim_slot_div=None, force_scan=False, ignore_preferences=None):
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    if claim_slot_div is not None:
        options.claim_slot_div = claim_slot_div
    if ignore_preferences is not None:
        options.ignore_preferences = ignore_preferences
    topo = PTopology(
        pools, ibp, pods, cluster=source, state_node_views=views,
        ignore_preferences=options.ignore_preferences,
    )
    sched = PT.TorchScheduler(pools, ibp, topo, views, daemons, options, device="cpu")
    sched.debug_force_scan = force_scan
    return sched.solve(pods), pods, sched


ODO_KEYS = (
    "steps", "bulk_steps", "tier_steps", "tier_hist", "dispatches", "overflow_signals", "regrows",
    "claims_opened", "claim_slots",
)


def _has_preferences(case: fuzz.FuzzCase) -> bool:
    pods = case.materialize()[2]
    return any(
        (p.node_affinity is not None and p.node_affinity.preferred)
        or p.pod_affinity_preferred
        or p.pod_anti_affinity_preferred
        or any(t.when_unsatisfiable == WhenUnsatisfiable.SCHEDULE_ANYWAY for t in p.topology_spread_constraints)
        for p in pods
    )


@pytest.mark.parametrize("seed", THREE_WAY_SEEDS)
def test_tiered_seed_three_way(seed):
    """Natural path: oracle == JAX == port, with the port's odometer equal
    to the JAX scheduler's; then forced scan, tight claim slots and (where
    the case has preferences) PreferencePolicy=Ignore against the oracle."""
    case = fuzz.generate_case(seed)
    assert fuzz.kernel_supported(case)
    want, pods_o = fuzz.solve_oracle(case)
    want_snap = fuzz.results_snapshot(want, pods_o)
    ref, pods_r, ref_sched = fuzz.solve_tpu(case)
    got, pods_t, sched = _solve_port(case)
    assert ref_sched.last_relax and sched.last_relax
    assert sched.last_used_runs == ref_sched.last_used_runs
    assert fuzz.results_snapshot(ref, pods_r) == want_snap
    assert fuzz.results_snapshot(got, pods_t) == want_snap
    for key in ODO_KEYS:
        assert sched.last_odometer[key] == ref_sched.last_odometer[key], key
    assert sched.last_odometer["tier_steps"] > 0
    scan, pods_s, _ = _solve_port(case, force_scan=True)
    assert fuzz.results_snapshot(scan, pods_s) == want_snap
    tight, pods_g, _ = _solve_port(case, claim_slot_div=10_000)
    assert fuzz.results_snapshot(tight, pods_g) == want_snap
    if _has_preferences(case):
        for ignore in (True, False):
            want_i, pods_oi = fuzz.solve_oracle(case, ignore_preferences=ignore)
            got_i, pods_ti, _ = _solve_port(case, ignore_preferences=ignore)
            assert fuzz.results_snapshot(got_i, pods_ti) == fuzz.results_snapshot(want_i, pods_oi)


# ---------------------------------------------------------------------------
# (e) relaxation-matrix scenarios through the port


def _base_pods(n=4):
    return [fixtures.pod(name=f"base-{i}", requests={"cpu": "200m"}) for i in range(n)]


def _or_terms():
    p = fixtures.pod(name="multi-term", requests={"cpu": "100m"})
    p.node_affinity = NodeAffinity(
        required_terms=[
            NodeSelectorTerm(match_expressions=[NodeSelectorRequirement(ZONE, Operator.IN, ["no-such-zone"])]),
            NodeSelectorTerm(match_expressions=[NodeSelectorRequirement(ZONE, Operator.IN, ["test-zone-b"])]),
        ]
    )
    return _base_pods() + [p]


def _pod_affinity_missing():
    out = _base_pods()
    for p in out:
        p.metadata.labels["app"] = "base"
    p = fixtures.pod(name="pref", labels={"app": "base"}, requests={"cpu": "100m"})
    p.pod_affinity_preferred = [
        WeightedPodAffinityTerm(
            weight=100,
            term=PodAffinityTerm(topology_key=HOSTNAME, label_selector=LabelSelector(match_labels={"app": "missing"})),
        )
    ]
    return out + [p]


def _weighted():
    p = fixtures.pod(name="weighted", labels={"app": "w"}, requests={"cpu": "100m"})
    p.pod_affinity_preferred = [
        WeightedPodAffinityTerm(
            weight=90,
            term=PodAffinityTerm(topology_key=ZONE, label_selector=LabelSelector(match_labels={"app": "missing"})),
        ),
        WeightedPodAffinityTerm(
            weight=10, term=PodAffinityTerm(topology_key=ZONE, label_selector=LabelSelector(match_labels={"app": "w"}))
        ),
    ]
    return _base_pods() + [p]


def _schedule_anyway():
    out = _base_pods(6)
    for i in range(3):
        out.append(
            fixtures.pod(
                name=f"anyway-{i}",
                labels={"app": "sa"},
                requests={"cpu": "100m"},
                topology_spread_constraints=[
                    TopologySpreadConstraint(
                        max_skew=1,
                        topology_key=ZONE,
                        when_unsatisfiable=WhenUnsatisfiable.SCHEDULE_ANYWAY,
                        label_selector=LabelSelector(match_labels={"app": "sa"}),
                    )
                ],
            )
        )
    return out


def _inverse_anti():
    return fixtures.make_pod_anti_affinity_pods(6, HOSTNAME) + fixtures.make_preference_pods(4)


MATRIX = {
    "or_terms": (_or_terms, False),
    "or_terms_ignore": (_or_terms, True),
    "pod_affinity_missing": (_pod_affinity_missing, False),
    "weighted": (_weighted, False),
    "schedule_anyway": (_schedule_anyway, False),
    "preference_mix": (lambda: fixtures.make_preference_pods(10), False),
    "inverse_anti": (_inverse_anti, False),
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_relaxation_matrix_scenario(name):
    make, ignore = MATRIX[name]
    fixtures.reset_rng(17)
    its = construct_instance_types(sizes=[2, 8])
    case = _case([fixtures.node_pool(name="default")], its, make(), SchedulerOptions(ignore_preferences=ignore))
    want, pods_o = fuzz.solve_oracle(case)
    want_snap = fuzz.results_snapshot(want, pods_o)
    assert not want_snap[2]  # every scenario lands all its pods
    ref, pods_r, _ = fuzz.solve_tpu(case)
    got, pods_t, sched = _solve_port(case)
    assert sched.last_relax
    assert fuzz.results_snapshot(ref, pods_r) == want_snap
    assert fuzz.results_snapshot(got, pods_t) == want_snap
