"""The port's consolidation controllers against the JAX package's, on the CPU.

Each fleet is built by the reference's control plane and carried across
with `convert.cluster` / `convert.candidates` (tests/test_torch_sweep.py's
helpers), so both sides decide on the same cluster; the port runs its
plain versions (`device="cpu"`). Every comparison is exact: candidate
names in order, decision, each replacement's instance type names in order,
and `command_savings` to rel_tol=1e-12.

- `build_budget_mapping` (tests/test_disruption.py:98, the reasons filter
  of :662) under budget sets of both kinds;
- the Commands of every method and of each `MultiNodeConsolidation` rung on
  the set-parity fleets and on fleets whose best command replaces (the
  spot-to-spot gate on), one with every simulation on the kernels
  (`tpu_min_pods=0`);
- the pinned non-prefix win (tests/test_setsweep.py:225), batched equals
  binary (tests/test_disruption.py:184, :479), single-node batched against
  the sequential walk (:1380), single-node's own timeout
  (tests/test_setsweep.py:454), the strategy guard (:513) and the batched
  rung falling to binary, not a linear scan (:413);
- drift and StaticDrift's node-limit reservation
  (tests/test_disruption.py:359);
- a `DisruptionController` round trip on both packages in step (propose,
  validate after the TTL, start, delete the originals), and the validation
  veto on pod churn (:237). These drive the controller alone, so the
  replacements' Initialized condition is set by hand on both sides; the
  round trip in which the Operator's lifecycle and termination controllers
  carry a Command through is
  tests/test_torch_operator.py::test_consolidation_round_trip_removes_nodes;
- a failure of the card (`_build.DeviceError` from a kernel launch, torch's
  out-of-memory error from a simulation) propagates out of
  `compute_commands` and `DisruptionController.reconcile`.
"""

import math
import os

import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.api.objects import COND_INITIALIZED as R_INITIALIZED
from karpenter_tpu.api.objects import Budget as RBudget
from karpenter_tpu.controllers import provisioning as rprovisioning
from karpenter_tpu.controllers.disruption import consolidation as rcons
from karpenter_tpu.controllers.disruption import controller as rctrl
from karpenter_tpu.controllers.disruption import helpers as rhelpers
from karpenter_tpu.controllers.disruption import queue as rqueue
from karpenter_tpu.controllers.disruption import setsweep as rset
from karpenter_tpu.controllers.disruption import staticdrift as rstatic
from karpenter_tpu.controllers.disruption.types import command_savings as r_savings
from karpenter_tpu.controllers.kube import FakeClock
from karpenter_tpu.controllers.operator import Operator
from karpenter_tpu.options import FeatureGates as RGates
from karpenter_tpu.options import Options as ROptions
from karpenter_tpu.testing import fixtures
from karpenter_tpu_torch import _build
from karpenter_tpu_torch.api.objects import COND_INITIALIZED as P_INITIALIZED
from karpenter_tpu_torch.api.objects import Budget as PBudget
from karpenter_tpu_torch.controllers import provisioning as pprovisioning
from karpenter_tpu_torch.controllers.disruption import consolidation as pcons
from karpenter_tpu_torch.controllers.disruption import controller as pctrl
from karpenter_tpu_torch.controllers.disruption import helpers as phelpers
from karpenter_tpu_torch.controllers.disruption import queue as pqueue
from karpenter_tpu_torch.controllers.disruption import setsweep as pset
from karpenter_tpu_torch.controllers.disruption import staticdrift as pstatic
from karpenter_tpu_torch.controllers.disruption import sweep as psweep
from karpenter_tpu_torch.controllers.disruption.types import command_savings as p_savings
from karpenter_tpu_torch.options import FeatureGates as PGates
from karpenter_tpu_torch.options import Options as POptions
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.testing import fixtures as pfixtures
from test_disruption import _snc_fleet, mark_consolidatable, settled_operator
from test_torch_setsweep import pinned_op
from test_torch_sweep import MATRIX_FLEETS, fleet_op, sides

# fleets whose best command replaces several nodes by one cheaper node: the
# KWOK catalog launches spot, so the spot-to-spot gate is on for them
REPLACE_FLEETS = [(11, 10, None, "1200m", "1500m", "256Mi"), (5, 6, [2, 8, 32], "1200m", "1500m", "128Mi")]
FLEETS = [f + ("128Mi",) for f in MATRIX_FLEETS] + REPLACE_FLEETS
FLEET_IDS = [f"seed{f[0]}-n{f[1]}" + ("-replace" if f in REPLACE_FLEETS else "") for f in FLEETS]
METHODS = ["sets", "batched", "binary", "single"]
# both sides' crossover: the defaults differ (the reference's 768, the
# port's the card's); at these sizes every simulation takes the oracle
MIN_PODS = 256


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


def options(fleet=None, tpu_min_pods=MIN_PODS, **kw):
    """(reference, port) Options alike: the spot-to-spot gate on for the
    replace fleets."""
    spot = fleet in REPLACE_FLEETS
    return (
        ROptions(tpu_min_pods=tpu_min_pods, feature_gates=RGates(spot_to_spot_consolidation=spot), **kw),
        POptions(tpu_min_pods=tpu_min_pods, feature_gates=PGates(spot_to_spot_consolidation=spot), **kw),
    )


def r_args(ref):
    return (ref.kube, ref.cluster, ref.cloud, ref.clock)


def p_args(port):
    return (port.kube, port.cluster, port.cloud, port.clock)


def view(cmd, savings) -> tuple:
    """A Command as the comparison sees it."""
    return (
        [c.name for c in cmd.candidates],
        cmd.decision,
        [[it.name for it in r.instance_type_options] for r in cmd.replacements],
        savings(cmd),
    )


def assert_same(r_cmds, p_cmds) -> None:
    want = [view(c, r_savings) for c in r_cmds]
    got = [view(c, p_savings) for c in p_cmds]
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        assert math.isclose(g[3], w[3], rel_tol=1e-12), (g[3], w[3])


def both_sides(op):
    """(reference, port) of the operator's cluster; the reference side
    carries its clock and provisioner."""
    ref, port = sides(op)
    ref.clock, ref.provisioner = op.clock, op.provisioner
    return ref, port


_SIDES: dict = {}


def fleet_sides(fleet):
    """Both sides of a fleet, built once per module run (read-only use)."""
    key = repr(fleet)
    if key not in _SIDES:
        _SIDES[key] = both_sides(fleet_op(*fleet))
    return _SIDES[key]


def method(mod, name, args, opts, **kw):
    if name == "single":
        return mod.SingleNodeConsolidation(*args, options=opts, **kw)
    return mod.MultiNodeConsolidation(*args, options=opts, sweep=name, **kw)


# ---------------------------------------------------------------------------
# budgets


BUDGET_SETS = {
    "default-10pct": [("10%", None)],
    "all": [("100%", None)],
    "count-2": [("2", None)],
    "reasons": [("0", ["drifted"]), ("100%", ["empty", "underutilized"])],
}


@pytest.mark.parametrize("budgets", sorted(BUDGET_SETS))
def test_budget_mapping_matches_reference(budgets):
    """tests/test_disruption.py:98 and :662: the allowance per pool for
    each reason, with one node already marked for deletion."""
    ref, port = both_sides(fleet_op(7, 5, [2, 8, 32], "400m", "700m"))
    for kube, cls in ((ref.kube, RBudget), (port.kube, PBudget)):
        np_ = kube.list("NodePool")[0]
        np_.disruption.budgets = [cls(nodes=n, reasons=r) for n, r in BUDGET_SETS[budgets]]
        kube.update("NodePool", np_)
    marked = ref.cands[0].name
    for side in (ref, port):
        side.cluster.mark_for_deletion(marked)
    for reason in ("underutilized", "drifted", "empty"):
        want = rhelpers.build_budget_mapping(ref.kube, ref.cluster, reason)
        got = phelpers.build_budget_mapping(port.kube, port.cluster, reason)
        assert got.allowed == want.allowed, reason
        assert [got.can_disrupt("default", n) for n in range(1, 7)] == [want.can_disrupt("default", n) for n in range(1, 7)]


# ---------------------------------------------------------------------------
# the methods' Commands


@pytest.mark.parametrize("name", METHODS)
@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
def test_commands_match_reference(fleet, name):
    """Every method's compute_commands on the same cluster: the reference
    with its kernels (force_oracle=False), the port with its plain
    versions."""
    ref, port = fleet_sides(fleet)
    ropts, popts = options(fleet)
    rset.last_search_stats.clear()
    pset.last_search_stats.clear()
    want = method(rcons, name, r_args(ref), ropts).compute_commands()
    got = method(pcons, name, p_args(port), popts, device="cpu").compute_commands()
    assert_same(want, got)
    savings = "winner_savings_per_hour"
    assert {k: v for k, v in pset.last_search_stats.items() if k != savings} == {
        k: v for k, v in rset.last_search_stats.items() if k != savings
    }
    assert math.isclose(pset.last_search_stats.get(savings, 0.0), rset.last_search_stats.get(savings, 0.0),
                        rel_tol=1e-12)
    assert bool(pset.last_search_stats) == (name == "sets")
    if fleet in REPLACE_FLEETS and name in ("sets", "batched"):
        assert got and got[0].decision == "replace"


def test_kernel_route_gives_the_default_routes_commands():
    """With tpu_min_pods=0 every simulation rides the kernels (their plain
    versions here); the Commands are the default route's (the oracle's at
    this size), which the test above holds to the reference's."""
    fleet = REPLACE_FLEETS[1]
    _ref, port = fleet_sides(fleet)
    _, popts = options(fleet)
    _, kernel_opts = options(fleet, tpu_min_pods=0)
    for name in ("sets", "batched"):
        want = method(pcons, name, p_args(port), popts, device="cpu").compute_commands()
        m = method(pcons, name, p_args(port), kernel_opts, device="cpu")
        got = m.compute_commands()
        assert want and want[0].decision == "replace"
        assert_same(want, got)
        assert m.simulate(got[0].candidates).used_tpu


def test_pinned_non_prefix_set_beats_every_prefix():
    """tests/test_setsweep.py:225: the sets rung removes the two 16-cpu
    nodes (a non-prefix set, 0.61 $/h) where every prefix saves 0.38 $/h."""
    ref, port = both_sides(pinned_op())
    ropts, popts = options()
    cands = port.cands
    got = {
        name: getattr(pcons.MultiNodeConsolidation(*p_args(port), options=popts, sweep=name, device="cpu"),
                      f"first_n_{name}")(cands)
        for name in ("sets", "batched")
    }
    got["binary"] = pcons.MultiNodeConsolidation(*p_args(port), options=popts, sweep="binary",
                                                 force_oracle=True).first_n_binary(cands)
    for name, cmd in got.items():
        want = getattr(rcons.MultiNodeConsolidation(*r_args(ref), options=ropts, sweep=name), f"first_n_{name}")(ref.cands)
        assert_same([want], [cmd])
    assert [c.name for c in got["sets"].candidates] == [c.name for c in cands[1:]]
    assert got["sets"].decision == "delete"
    assert p_savings(got["sets"]) > p_savings(got["batched"]) + 1e-6
    assert math.isclose(p_savings(got["batched"]), p_savings(got["binary"]), rel_tol=1e-12)
    assert (round(p_savings(got["sets"]), 2), round(p_savings(got["batched"]), 2)) == (0.61, 0.38)
    assert pset.last_search_stats["winner_nodes"] == 2


def _settled_184():
    op = settled_operator(n_pods=8, pod_kw=dict(requests={"cpu": "300m", "memory": "256Mi"}))
    mark_consolidatable(op)
    np_ = op.kube.list("NodePool")[0]
    np_.disruption.budgets[0].nodes = "100%"
    op.kube.update("NodePool", np_)
    return op


@pytest.mark.parametrize("make,least", [(_settled_184, 0), (lambda: fleet_op(21, 8, [2, 32], "100m", "700m"), 5)],
                         ids=["settled-184", "fleet-479"])
def test_batched_equals_binary(make, least):
    """tests/test_disruption.py:184 and :479: the batched rung on the
    kernels (K6) gives the binary search's Command on the oracle, and both
    equal the reference's (at least `least` nodes removed)."""
    ref, port = both_sides(make())
    ropts, popts = options()
    batched = pcons.MultiNodeConsolidation(*p_args(port), options=popts, sweep="batched", device="cpu")
    binary = pcons.MultiNodeConsolidation(*p_args(port), options=popts, sweep="binary", force_oracle=True)
    psweep.last_sweep.clear()
    got_a, got_b = batched.compute_commands(), binary.compute_commands()
    assert sum(len(c.candidates) for c in got_a) >= least
    if least:
        assert psweep.last_sweep["path"] == "sweep_fast"
    assert_same(got_b, got_a)
    want = rcons.MultiNodeConsolidation(*r_args(ref), options=ropts, sweep="binary", force_oracle=True).compute_commands()
    assert_same(want, got_a)


def test_single_node_batched_agrees_with_sequential():
    """tests/test_disruption.py:1380: the singleton lanes (K6) skip only
    what the sequential walk would find a no-op."""
    ref, port = both_sides(_snc_fleet(8))
    ropts, popts = options()
    got_a = pcons.SingleNodeConsolidation(*p_args(port), options=popts, device="cpu").compute_commands()
    assert psweep.last_sweep["path"] == "sweep_fast" and psweep.last_sweep["lanes"] == len(port.cands)
    got_b = pcons.SingleNodeConsolidation(*p_args(port), options=popts, sweep="sequential",
                                          force_oracle=True).compute_commands()
    want = rcons.SingleNodeConsolidation(*r_args(ref), options=ropts, sweep="sequential",
                                         force_oracle=True).compute_commands()
    assert got_a
    assert_same(want, got_a)
    assert_same(want, got_b)


@pytest.mark.parametrize("spent", ["multinode", "singlenode"])
def test_single_node_has_own_timeout(spent):
    """tests/test_setsweep.py:454: a spent multi-node budget does not stop
    the single-node walk, and a spent single-node one stops only it."""
    assert POptions().singlenode_consolidation_timeout_seconds == 180.0
    assert POptions().multinode_consolidation_timeout_seconds == 60.0
    ref, port = both_sides(fleet_op(21, 4, [2, 32], "100m", "700m"))
    kw = {f"{spent}_consolidation_timeout_seconds": -1.0}
    ropts, popts = options(**kw)
    for name in ("single", "binary"):
        want = method(rcons, name, r_args(ref), ropts, force_oracle=True).compute_commands()
        got = method(pcons, name, p_args(port), popts, device="cpu").compute_commands()
        assert_same(want, got)
        if spent == "multinode":
            assert bool(got) == (name == "single")
        elif name == "single":
            assert not got


def test_strategy_guard():
    """tests/test_setsweep.py:513: an unknown rung fails fast."""
    with pytest.raises(ValueError, match="sweep strategy"):
        pcons.MultiNodeConsolidation(None, None, None, None, sweep="prefix", device="cpu")


def test_batched_fallback_is_binary_not_linear(monkeypatch):
    """tests/test_setsweep.py:413: where the prefix sweep cannot express the
    shape, the batched rung bisects (at most ceil(log2 n) + 1
    simulations)."""
    ref, port = fleet_sides((21, 8, [2, 32], "100m", "700m", "128Mi"))
    ropts, popts = options()

    def unsupported(consolidation, candidates):
        raise psweep.SweepUnsupported("forced for the test")

    monkeypatch.setattr(pcons, "sweep_first_n", unsupported)
    mnc = pcons.MultiNodeConsolidation(*p_args(port), options=popts, sweep="batched", device="cpu")
    calls = []
    orig = mnc.compute_consolidation
    mnc.compute_consolidation = lambda cands: calls.append(len(cands)) or orig(cands)
    got = mnc.first_n_batched(port.cands)
    n = len(port.cands)
    assert n >= 6 and len(calls) <= math.ceil(math.log2(n)) + 1, calls
    want = rcons.MultiNodeConsolidation(*r_args(ref), options=ropts, sweep="binary", force_oracle=True).first_n_binary(ref.cands)
    assert_same([want], [got])


# ---------------------------------------------------------------------------
# drift


def _drift_op():
    op = settled_operator(n_pods=3)
    np_ = op.kube.list("NodePool")[0]
    np_.disruption.budgets = [RBudget(nodes="100%")]
    np_.template.labels["fleet"] = "v2"  # drift everything
    op.kube.update("NodePool", np_)
    op.nodepool_hash.reconcile_all()
    mark_consolidatable(op)
    op.claim_conditions.reconcile_all()
    return op


def test_drift_commands_match_reference():
    """DriftConsolidation replaces the first drifted node with the claims
    its simulation opens."""
    ref, port = both_sides(_drift_op())
    ropts, popts = options()
    want = rcons.DriftConsolidation(*r_args(ref), options=ropts).compute_commands()
    got = pcons.DriftConsolidation(*p_args(port), options=popts, device="cpu").compute_commands()
    assert want and want[0].reason == "drifted"
    assert_same(want, got)


def _static_op(limit):
    op = Operator(clock=FakeClock(), force_oracle=True,
                  options=ROptions(feature_gates=RGates(static_capacity=True)))
    limits = {"nodes": limit} if limit else {}
    op.kube.create("NodePool", fixtures.node_pool(name="warm", replicas=2, limits=limits))
    op.run_until_settled(max_ticks=40)
    np_ = op.kube.list("NodePool")[0]
    np_.template.labels["fleet"] = "v2"
    np_.disruption.budgets[0].nodes = "100%"
    op.kube.update("NodePool", np_)
    op.nodepool_hash.reconcile_all()
    op.claim_conditions.reconcile_all()
    return op


@pytest.mark.parametrize("limit", [None, "3", "2"], ids=["no-limit", "limit-3", "limit-2"])
def test_static_drift_reservations_match_reference(limit):
    """tests/test_disruption.py:359: StaticDrift reserves each replacement
    against the pool's `nodes` limit; at the replica count (2) nothing is
    granted. Both sides name the replacements from the same sequence
    value."""
    ref, port = both_sides(_static_op(limit))
    pstatic._replacement_seq[0] = rstatic._replacement_seq[0]
    want = rstatic.StaticDrift(*r_args(ref)).compute_commands()
    got = pstatic.StaticDrift(*p_args(port), device="cpu").compute_commands()
    assert [(c.candidates[0].name, c.replacements[0].name, c.reserved_pool, c.reserved_count) for c in got] == [
        (c.candidates[0].name, c.replacements[0].name, c.reserved_pool, c.reserved_count) for c in want
    ]
    assert len(got) == {None: 2, "3": 1, "2": 0}[limit]
    assert port.cluster.nodepool_state._reserved == ref.cluster.nodepool_state._reserved


# ---------------------------------------------------------------------------
# the controller


def controllers(ref, port, ropts, popts):
    rc = rctrl.DisruptionController(*r_args(ref)[:3], ref.provisioner, ref.clock, ropts)
    prov = pprovisioning.Provisioner(*p_args(port), popts, device="cpu")
    pc = pctrl.DisruptionController(*p_args(port)[:3], prov, port.clock, popts, device="cpu")
    return rc, pc, prov


def initialize_replacements(kube, names, cond) -> None:
    """What the lifecycle controller does once a replacement's node
    initializes (these tests drive the DisruptionController alone)."""
    for name in names:
        claim = kube.get("NodeClaim", name)
        claim.status.conditions[cond] = "True"
        kube.update("NodeClaim", claim)


def live_nodes(cluster) -> set:
    return {sn.name for sn in cluster.state_nodes() if sn.node is not None
            and not (sn.marked_for_deletion or sn.deleting())}


@pytest.mark.parametrize("fleet", [FLEETS[0], REPLACE_FLEETS[1]], ids=["delete", "replace"])
def test_controller_round_trip_in_step(fleet):
    """Both controllers propose the same Command, validate it after the TTL
    and start it (replacements through each side's Provisioner), then,
    with the replacements initialized, delete the same originals; the
    removed nodes' pods are what the next provisioning round places."""
    ref, port = both_sides(fleet_op(*fleet))
    ropts, popts = options(fleet)
    rc, pc, prov = controllers(ref, port, ropts, popts)
    pprovisioning._claim_name_seq[0] = rprovisioning._claim_name_seq[0]
    before = live_nodes(port.cluster)
    assert before == live_nodes(ref.cluster)
    cmds_before = pqueue.COMMANDS_EXECUTED.value({"decision": "replace" if fleet in REPLACE_FLEETS else "delete",
                                                  "reason": "underutilized"})

    # 1. propose
    assert rc.reconcile() is None and pc.reconcile() is None
    assert_same([rc._pending_validation[1]], [pc._pending_validation[1]])
    # 2. validate after the TTL and start
    for side in (ref, port):
        side.clock.advance(rqueue.VALIDATION_TTL_SECONDS)
    want, got = rc.reconcile(), pc.reconcile()
    assert got is not None
    assert_same([want], [got])
    r_new = rc.queue.in_flight[0].replacement_names
    p_new = pc.queue.in_flight[0].replacement_names
    assert p_new == r_new and len(p_new) == len(got.replacements)
    assert pqueue.COMMANDS_EXECUTED.value({"decision": got.decision, "reason": got.reason}) == cmds_before + 1
    # 3. replacements initialized: the originals' claims go
    initialize_replacements(ref.kube, r_new, R_INITIALIZED)
    initialize_replacements(port.kube, p_new, P_INITIALIZED)
    for side in (ref, port):
        side.clock.advance(2.0)
    rc.reconcile()
    pc.reconcile()
    assert not pc.queue.busy and not rc.queue.busy
    removed = {c.name for c in got.candidates}
    assert live_nodes(port.cluster) == live_nodes(ref.cluster) == before - removed
    deleting = {c.name for c in port.kube.list("NodeClaim") if c.metadata.deletion_timestamp is not None}
    assert deleting == {c.claim_name() for c in got.candidates}
    # the third reconcile proposed on the smaller cluster in step
    r_next, p_next = rc._pending_validation, pc._pending_validation
    assert (r_next is None) == (p_next is None)
    if p_next is not None:
        assert_same([r_next[1]], [p_next[1]])
    # every pod is bound to a live node or waits for the next round
    waiting = {p.name for p in prov.get_pending_pods() + prov._reschedulable_from_deleting_nodes()}
    live = live_nodes(port.cluster)
    for p in port.kube.list("Pod"):
        assert p.node_name in live or p.name in waiting, p.name
    assert waiting == {p.name for c in got.candidates for p in c.reschedulable_pods}


def test_validation_vetoes_on_pod_churn():
    """tests/test_disruption.py:237: an emptiness Command awaiting
    validation is vetoed on both sides when a pod lands on its node."""
    op = settled_operator(n_pods=2)
    for p in op.kube.list("Pod"):
        op.kube.delete("Pod", p.name)
    mark_consolidatable(op)
    np_ = op.kube.list("NodePool")[0]
    np_.disruption.budgets[0].nodes = "100%"
    op.kube.update("NodePool", np_)
    ref, port = both_sides(op)
    ropts, popts = options()
    rc, pc, _ = controllers(ref, port, ropts, popts)
    assert rc.reconcile() is None and pc.reconcile() is None
    assert pc._pending_validation is not None and pc._pending_validation[1].reason == "empty"
    assert_same([rc._pending_validation[1]], [pc._pending_validation[1]])
    node = ref.kube.list("Node")[0].name
    ref.kube.create("Pod", fixtures.pod(name="intruder", requests={"cpu": "100m"}))
    port.kube.create("Pod", pfixtures.pod(name="intruder", requests={"cpu": "100m"}))
    for side in (ref, port):
        side.kube.bind("intruder", node)
        side.clock.advance(16.0)
    assert rc.reconcile() is None and pc.reconcile() is None
    assert not pc.queue.busy and not rc.queue.busy
    assert live_nodes(port.cluster) == live_nodes(ref.cluster) == {n.name for n in port.kube.list("Node")}


# ---------------------------------------------------------------------------
# a failure of the card is not a rung of the ladder


def _device_error(*args, **kwargs):
    raise _build.DeviceError("set_sweep: launch failed (cudaErrorLaunchFailure)")


def _out_of_memory(self, pods, trace=None):
    raise torch.OutOfMemoryError("CUDA out of memory")


FAILURES = {
    # (patch target, name, replacement, method, tpu_min_pods)
    "k8-launch": (pset, "set_sweep", _device_error, "sets", MIN_PODS),
    "k6-launch": (psweep, "fast_sweep", _device_error, "batched", MIN_PODS),
    "k6-singleton-launch": (psweep, "fast_sweep", _device_error, "single", MIN_PODS),
    "simulation-oom": (TorchScheduler, "solve", _out_of_memory, "binary", 0),
}


@pytest.mark.parametrize("failure", sorted(FAILURES))
def test_device_failure_propagates(monkeypatch, failure):
    """A DeviceError from a sweep kernel's launch, or torch's out-of-memory
    error from a simulation on the kernels, leaves compute_commands and
    DisruptionController.reconcile: the ladder does not take it to a lower
    rung or to the oracle."""
    target, name, fn, how, min_pods = FAILURES[failure]
    _ref, port = fleet_sides(FLEETS[0])
    popts = POptions(tpu_min_pods=min_pods, multinode_sweep_strategy="sets" if how == "single" else how)
    monkeypatch.setattr(target, name, fn)
    m = method(pcons, how, p_args(port), popts, device="cpu")
    walked = []
    if how != "binary":
        # no rung below the failed sweep, and no sequential walk, runs
        monkeypatch.setattr(m, "compute_consolidation", walked.append)
    with pytest.raises(RuntimeError) as raised:
        m.compute_commands()
    assert isinstance(raised.value, (_build.DeviceError, torch.OutOfMemoryError))
    assert not walked
    if how == "single":
        return
    prov = pprovisioning.Provisioner(*p_args(port), popts, device="cpu")
    ctrl = pctrl.DisruptionController(*p_args(port)[:3], prov, port.clock, popts, device="cpu")
    with pytest.raises(RuntimeError) as raised:
        ctrl.reconcile()
    assert isinstance(raised.value, (_build.DeviceError, torch.OutOfMemoryError))
    assert ctrl._pending_validation is None
