"""The paths chip_smoke.py's gates phase drives on the card, against the JAX
package on the CPU.

Every simulation and solve takes the kernel route on both sides
(`Options(tpu_min_pods=0)`): the JAX package's kernels on its CPU backend,
the port's plain versions (`device="cpu"`). Fleets come from the
reference's control plane and are carried across with
tests/test_torch_consolidation.py's helpers; Commands are compared by
candidate names, decision, each replacement's instance type names and
`command_savings` (`assert_same`).

- a replace Command from the sets and batched rungs on a `REPLACE_FLEETS`
  fleet, and from single-node consolidation on one over-sized spot node
  (the spot-to-spot gate on, at least 15 cheaper types);
- DriftConsolidation's Command;
- the Validator's re-simulation passing a replace Command, and vetoing it
  once pending pods need more new claims than it replaces;
- the Operator with all five feature gates on: a price NodeOverlay, a
  capacity NodeOverlay whose extended resource some pods request, a static
  pool drifted and scaled down, and a node repaired (tests/
  test_torch_operator.py's `twin`: per-tick node counts, claims, bindings,
  Commands and the repaired count);
- on the port alone, the DeviceTableCache across an overlay change: a
  price change leaves every device table as it was (a hit), a capacity
  change misses.
"""

from __future__ import annotations

import copy
import importlib
import types

import pytest

from karpenter_tpu.api.objects import PodPhase as RPodPhase
from karpenter_tpu.controllers.disruption import consolidation as rcons
from karpenter_tpu.controllers.disruption import queue as rqueue
from karpenter_tpu.controllers.kube import FakeClock as RFakeClock
from karpenter_tpu.controllers.operator import Operator as ROperator
from karpenter_tpu.options import FeatureGates as RGates
from karpenter_tpu.options import Options as ROptions
from karpenter_tpu.testing import fixtures
from karpenter_tpu_torch.controllers.disruption import consolidation as pcons
from karpenter_tpu_torch.controllers.disruption import queue as pqueue
from karpenter_tpu_torch.testing import fixtures as pfixtures
from test_disruption import mark_consolidatable
from test_torch_consolidation import (  # noqa: F401 - the module's compile-cache fixture
    REPLACE_FLEETS,
    _drift_op,
    _no_persistent_compile_cache,
    assert_same,
    both_sides,
    fleet_sides,
    method,
    options,
    p_args,
    r_args,
)
from test_torch_operator import REF, PORT, claims_view, operator, twin

def _spot_node_op():
    """tests/test_disruption.py's spot-to-spot case: one big spot node whose
    seed is swapped for a 100m rider; on REPLACE_FLEETS[1]'s catalog a
    32-cpu node has 24 cheaper spot types (at least 15)."""
    from karpenter_tpu.api import labels as well_known
    from karpenter_tpu.api.objects import Budget, NodeSelectorRequirement
    from karpenter_tpu.api.objects import Operator as Op
    from karpenter_tpu.cloudprovider.kwok import construct_instance_types

    op = ROperator(clock=RFakeClock(), force_oracle=True,
                   options=ROptions(feature_gates=RGates(spot_to_spot_consolidation=True)))
    op.raw_cloud.types = construct_instance_types(sizes=REPLACE_FLEETS[1][2])
    op.raw_cloud._by_name = {it.name: it for it in op.raw_cloud.types}
    op.kube.create("NodePool", fixtures.node_pool(
        name="default", budgets=[Budget(nodes="100%")],
        requirements=[NodeSelectorRequirement(well_known.CAPACITY_TYPE_LABEL_KEY, Op.IN, ["spot"])]))
    op.kube.create("Pod", fixtures.pod(name="seed", requests={"cpu": "30", "memory": "6Gi"}))
    op.run_until_settled(max_ticks=40)
    node_name = op.kube.get("Pod", "seed").node_name
    op.kube.delete("Pod", "seed")
    rider = fixtures.pod(name="rider", requests={"cpu": "100m"})
    rider.node_name = node_name
    rider.phase = RPodPhase.RUNNING
    op.kube.create("Pod", rider)
    mark_consolidatable(op)
    return op


@pytest.mark.parametrize("name", ["sets", "batched", "single"])
def test_replace_commands_on_the_kernels(name):
    """Each method's replace Command with every simulation on the kernels:
    the multi-node rungs on REPLACE_FLEETS[1], single-node on the
    over-sized spot node (single-node finds no replace on an under-utilized
    fleet: each rider fits on another node)."""
    fleet = REPLACE_FLEETS[1]
    ref, port = both_sides(_spot_node_op()) if name == "single" else fleet_sides(fleet)
    ropts, popts = options(fleet, tpu_min_pods=0)  # the spot-to-spot gate on
    want = method(rcons, name, r_args(ref), ropts).compute_commands()
    m = method(pcons, name, p_args(port), popts, device="cpu")
    got = m.compute_commands()
    assert got and got[0].decision == "replace"
    assert_same(want, got)
    assert m.simulate(got[0].candidates).used_tpu


def test_drift_command_on_the_kernels():
    """DriftConsolidation's simulation on the kernels gives the reference's
    Command."""
    ref, port = both_sides(_drift_op())
    ropts, popts = options(tpu_min_pods=0)
    want = rcons.DriftConsolidation(*r_args(ref), options=ropts).compute_commands()
    got = pcons.DriftConsolidation(*p_args(port), options=popts, device="cpu").compute_commands()
    assert got and got[0].reason == "drifted"
    assert_same(want, got)


@pytest.mark.parametrize("veto", [False, True], ids=["pass", "veto"])
def test_validator_resimulation_on_the_kernels(veto):
    """The Validator's re-simulation of a replace Command on the kernels:
    it passes on the fleet as it is; with two pending pods that each need a
    new claim of their own (hostname anti-affinity) it is vetoed; each
    verdict equals the reference's."""
    from karpenter_tpu.api import labels as well_known
    from karpenter_tpu.api.objects import LabelSelector, PodAffinityTerm
    from karpenter_tpu_torch.api.objects import LabelSelector as PLabelSelector
    from karpenter_tpu_torch.api.objects import PodAffinityTerm as PPodAffinityTerm

    fleet = REPLACE_FLEETS[1]
    ref, port = both_sides(fixtures_fleet(fleet))
    ropts, popts = options(fleet, tpu_min_pods=0)
    want_cmd = rcons.MultiNodeConsolidation(*r_args(ref), options=ropts).compute_commands()[0]
    got_cmd = pcons.MultiNodeConsolidation(*p_args(port), options=popts, device="cpu").compute_commands()[0]
    assert got_cmd.decision == "replace"
    assert_same([want_cmd], [got_cmd])
    if veto:
        for kube, fx, term, sel in ((ref.kube, fixtures, PodAffinityTerm, LabelSelector),
                                    (port.kube, pfixtures, PPodAffinityTerm, PLabelSelector)):
            for i in range(2):
                kube.create("Pod", fx.pod(
                    name=f"veto-{i}", labels={"fleet": "veto"}, requests={"cpu": "6", "memory": "1Gi"},
                    pod_anti_requirements=[term(topology_key=well_known.HOSTNAME_LABEL_KEY,
                                                label_selector=sel(match_labels={"fleet": "veto"}))]))
    want = rqueue.Validator(*r_args(ref), ropts).validate(want_cmd)
    got = pqueue.Validator(*p_args(port), popts, device="cpu").validate(got_cmd)
    assert got == want == (not veto)


def fixtures_fleet(fleet):
    """A fresh reference operator of a REPLACE_FLEETS fleet (the module's
    cached sides are read-only; this test adds pods)."""
    from test_torch_sweep import fleet_op

    return fleet_op(*fleet)


# ---------------------------------------------------------------------------
# the Operator with every feature gate on


def _gated_side(s) -> types.SimpleNamespace:
    """tests/test_torch_operator.py's side `s` with the overlay and repair
    modules and FeatureGates of its package."""
    pkg = s.objects.__name__.split(".")[0]
    extra = {alias: importlib.import_module(f"{pkg}.{mod}")
             for alias, mod in (("nodeoverlay", "controllers.nodeoverlay"), ("nodepool_aux", "controllers.nodepool_aux"))}
    return types.SimpleNamespace(**vars(s), **extra, FeatureGates=importlib.import_module(f"{pkg}.options").FeatureGates)


def gated_operator_scenario(s) -> dict:
    """chip_smoke.py's gated Operator at a small size: a dynamic pool
    (consolidateAfter 0, a 100% budget) and a static pool of 2 replicas,
    a -50% price overlay on family c and a capacity overlay giving family m
    4 `example.com/gpu`, which every fourth of 12 pods requests (a
    node of family m comes up with them, as its device plugin would
    advertise them); settle; a dynamic node Ready=False past the repair
    toleration, its pods re-created once evicted and placed again; the
    static pool drifted, then scaled to 1."""
    g = _gated_side(s)
    gates = g.FeatureGates(node_repair=True, reserved_capacity=True, spot_to_spot_consolidation=True,
                           node_overlay=True, static_capacity=True)
    op = operator(s, options=s.Options(tpu_min_pods=0, feature_gates=gates))
    family = s.kwok.INSTANCE_FAMILY_LABEL_KEY
    nodepool = s.labels.NODEPOOL_LABEL_KEY
    op.kube.create("NodePool", s.fixtures.node_pool(name="default", budgets=[s.objects.Budget(nodes="100%")]))
    op.kube.create("NodePool", s.fixtures.node_pool(name="static", replicas=2,
                                                    budgets=[s.objects.Budget(nodes="100%")]))
    for name, fam, patch in (("price", "c", {"price_adjustment": "-50%"}),
                             ("gpu", "m", {"capacity": {"example.com/gpu": 4000}})):
        op.kube.create("NodeOverlay", g.nodeoverlay.NodeOverlay(
            metadata=s.objects.ObjectMeta(name=name),
            requirements=[s.objects.NodeSelectorRequirement(family, s.objects.Operator.IN, [fam])], **patch))
    for i in range(12):
        requests = {"cpu": f"{300 + 100 * (i % 5)}m", "memory": "256Mi"}
        if i % 4 == 0:
            requests["example.com/gpu"] = "1"
        op.kube.create("Pod", s.fixtures.pod(name=f"w-{i}", requests=requests))
    raw_create = op.raw_cloud.create

    def create(claim):
        out = raw_create(claim)
        if out.metadata.labels.get(family) == "m":
            node = op.raw_cloud._pending_nodes[-1][1]
            for rl in (out.status.capacity, out.status.allocatable, node.capacity, node.allocatable):
                rl["example.com/gpu"] = 4000
        return out

    op.raw_cloud.create = create
    commands = []
    reconcile = op.disruption.reconcile

    def recorded():
        cmd = reconcile()
        if cmd is not None:
            commands.append((cmd.reason, cmd.decision, sorted(c.name for c in cmd.candidates),
                             [sorted(it.name for it in r.instance_type_options) if hasattr(r, "instance_type_options")
                              else r.metadata.name for r in cmd.replacements]))
        return cmd

    op.disruption.reconcile = recorded
    rec = []

    def tick(advance):
        op.step(advance)
        rec.append(len(op.kube.list("Node")))

    for _ in range(20):
        tick(2.0)
        if op.settled():
            break
    provisioned = claims_view(s, op)
    repaired0 = g.nodepool_aux.NODES_REPAIRED.value({"condition": "Ready"})
    broken = sorted(n.name for n in op.kube.list("Node") if n.metadata.labels.get(nodepool) == "default")[0]
    # the broken node's pods, re-created by their workload once evicted
    evictees = {p.name: p for p in op.kube.list("Pod") if p.node_name == broken}
    node = op.kube.get("Node", broken)
    node.conditions["Ready"] = "False"
    node.ready = False
    op.kube.update("Node", node)

    def repair_tick(advance):
        tick(advance)
        for name, pod in evictees.items():
            if op.kube.try_get("Pod", name) is None:
                fresh = copy.deepcopy(pod)
                fresh.node_name, fresh.phase, fresh.terminating = "", s.objects.PodPhase.PENDING, False
                fresh.metadata.creation_timestamp = 0.0
                op.kube.create("Pod", fresh)

    repair_tick(2.0)
    repair_tick(121.0)
    repaired = g.nodepool_aux.NODES_REPAIRED.value({"condition": "Ready"}) - repaired0
    for _ in range(10):
        repair_tick(2.0)
    replaced = sorted((name, op.kube.get("Pod", name).node_name) for name in evictees)
    pool = op.kube.get("NodePool", "static")
    pool.template.labels["fleet"] = "v2"
    op.kube.update("NodePool", pool)
    for _ in range(14):
        tick(16.0)
    pool = op.kube.get("NodePool", "static")
    pool.replicas = 1
    op.kube.update("NodePool", pool)
    for _ in range(6):
        tick(16.0)
    op.disruption.reconcile = reconcile
    nodes = {n.name: n for n in op.kube.list("Node")}
    gpu_families = sorted({nodes[p.node_name].metadata.labels.get(family) if p.node_name in nodes else None
                           for p in op.kube.list("Pod") if p.requests.get("example.com/gpu")})
    static = [n for n in nodes.values() if n.metadata.labels.get(nodepool) == "static"]
    return {
        "ticks": rec, "provisioned": provisioned, "claims": claims_view(s, op),
        "bindings": sorted((p.name, p.node_name) for p in op.kube.list("Pod")), "commands": commands,
        "repaired": repaired, "broken": broken, "replaced": replaced, "gpu_families": gpu_families,
        "static": sorted((n.name, n.metadata.labels.get("fleet")) for n in static),
        "route": op.provisioner.last_solver_used,
    }


def test_gated_operator_twin():
    """Both Operators, every feature gate on, decide alike tick by tick."""
    got = twin(gated_operator_scenario)
    assert got["route"] == "tpu" and got["repaired"] == 1
    assert got["replaced"] and all(node and node != got["broken"] for _, node in got["replaced"])
    assert got["gpu_families"] == ["m"]
    assert [c for c in got["commands"] if c[0] == "drifted"] and len(got["static"]) == 1
    assert all(fleet == "v2" for _, fleet in got["static"])
    assert all(node for _, node in got["bindings"])


# ---------------------------------------------------------------------------
# the table cache across an overlay change (the port alone)


@pytest.mark.parametrize("change,outcome", [("price", "hit"), ("capacity", "miss")])
def test_table_cache_across_an_overlay_change(change, outcome):
    """solve_in_process with one DeviceTableCache before and after an
    overlay change: no device table holds a price, so a price change hits
    (the decode prices the claims on the host from the overlaid types); a
    capacity change misses. Either way the cached solve equals an uncached
    one."""
    from karpenter_tpu_torch.solver import epochs
    from karpenter_tpu_torch.solver.hybrid import solve_in_process
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions
    from karpenter_tpu_torch.testing.fuzz import results_snapshot

    s = _gated_side(PORT)
    op = operator(s, options=s.Options(tpu_min_pods=0, feature_gates=s.FeatureGates(node_overlay=True)))
    family = s.kwok.INSTANCE_FAMILY_LABEL_KEY
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("NodeOverlay", s.nodeoverlay.NodeOverlay(
        metadata=s.objects.ObjectMeta(name="ov"),
        requirements=[s.objects.NodeSelectorRequirement(family, s.objects.Operator.IN, ["m"])],
        **({"price_adjustment": "-50%"} if change == "price" else {"capacity": {"example.com/gpu": 4000}})))
    op.node_overlay.reconcile_all()
    pool = op.kube.get("NodePool", "default")
    s.fixtures.reset_rng(32)
    pods = s.fixtures.make_generic_pods(24)
    for p in pods[::6]:
        p.requests["example.com/gpu"] = 1000
    cache = epochs.DeviceTableCache()
    opts = SchedulerOptions(tpu_min_pods=0)

    def solve(table_cache):
        res, sched = solve_in_process([pool], {"default": op.cloud.get_instance_types(pool)}, pods, options=opts,
                                      table_cache=table_cache, device="cpu")
        assert sched.used_tpu
        return results_snapshot(res, pods)

    solve(cache)
    ov = op.kube.get("NodeOverlay", "ov")
    if change == "price":
        ov.price_adjustment = "-20%"
    else:
        ov.capacity = {"example.com/gpu": 8000}
    op.kube.update("NodeOverlay", ov)
    op.node_overlay.reconcile_all()
    before = {k: epochs.TABLE_CACHE.value({"outcome": k}) for k in ("hit", "miss")}
    got = solve(cache)
    assert {k: epochs.TABLE_CACHE.value({"outcome": k}) - v for k, v in before.items()} == {
        "hit": float(outcome == "hit"), "miss": float(outcome == "miss")}
    assert got == solve(None)
