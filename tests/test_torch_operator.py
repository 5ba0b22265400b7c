"""The port's Operator against the JAX package's, on the CPU.

Each scenario runs from the same seed through the reference's Operator
(`force_oracle=False`, its kernels on JAX's CPU backend) and through the
port's (`device="cpu"`, the kernels' plain versions), both with
`Options(tpu_min_pods=0)` so every solve takes the kernel route. Each side
records the node count after every tick, the settled NodeClaims (as
chip_smoke.py's `claims_view` compares them: without names, uids, versions,
creation times and synthetic hostnames) and the pod bindings; the two
records must be equal. Both packages name claims from a module counter, so
the port's counters start where the reference's did.

Twins of tests/test_control_plane.py (the e2e flow :39, scale existing
first :77, lifecycle liveness :96, the termination drain :118, the
PDB-blocked eviction :142, volume topology :170, requirements drift :455),
of the chaos guards tests/test_chaos.py:41 and :69 at their sizes, and a
consolidation round trip in which the lifecycle and termination
controllers, not a hand-set condition, carry the Command from proposal to
removed nodes.
"""

from __future__ import annotations

import json
import os
import types

import pytest

os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""


def _side(name: str) -> types.SimpleNamespace:
    if name == "ref":
        from karpenter_tpu.api import codec, labels, objects
        from karpenter_tpu.cloudprovider import kwok, types as cptypes
        from karpenter_tpu.controllers import operator, provisioning, static
        from karpenter_tpu.controllers.disruption import staticdrift
        from karpenter_tpu.controllers.kube import FakeClock
        from karpenter_tpu.options import Options
        from karpenter_tpu.testing import fixtures

        def make(**kw):
            return operator.Operator(clock=FakeClock(), force_oracle=False, **kw)

    else:
        from karpenter_tpu_torch.api import codec, labels, objects
        from karpenter_tpu_torch.cloudprovider import kwok, types as cptypes
        from karpenter_tpu_torch.controllers import operator, provisioning, static
        from karpenter_tpu_torch.controllers.disruption import staticdrift
        from karpenter_tpu_torch.controllers.kube import FakeClock
        from karpenter_tpu_torch.options import Options
        from karpenter_tpu_torch.testing import fixtures

        def make(**kw):
            return operator.Operator(clock=FakeClock(), device="cpu", **kw)

    return types.SimpleNamespace(
        name=name, codec=codec, labels=labels, objects=objects, kwok=kwok, cptypes=cptypes,
        provisioning=provisioning, static=static, staticdrift=staticdrift, Options=Options, fixtures=fixtures,
        make=make,
    )


REF = _side("ref")
PORT = _side("port")


def operator(s, sizes=(2, 8, 32), **kw):
    """small_operator of tests/test_control_plane.py on the kernel route."""
    kw.setdefault("options", s.Options(tpu_min_pods=0))
    op = s.make(**kw)
    op.raw_cloud.types = s.kwok.construct_instance_types(sizes=list(sizes))
    op.raw_cloud._by_name = {it.name: it for it in op.raw_cloud.types}
    return op


def claims_view(s, op) -> list:
    out = []
    for c in op.kube.list("NodeClaim"):
        d = s.codec.to_jsonable(c)
        for k in ("name", "uid", "resource_version", "creation_timestamp"):
            d["metadata"].pop(k, None)
        d["metadata"]["labels"].pop(s.labels.HOSTNAME_LABEL_KEY, None)
        out.append(json.dumps(d, sort_keys=True))
    return sorted(out)


def snapshot(s, op) -> dict:
    return {
        "claims": claims_view(s, op),
        "nodes": sorted(n.name for n in op.kube.list("Node")),
        "bindings": sorted((p.name, p.node_name) for p in op.kube.list("Pod")),
        "settled": op.settled(),
    }


def settle(op, rec: list, max_ticks: int = 30) -> int:
    """`run_until_settled`, recording the node count after every tick."""
    for tick in range(1, max_ticks + 1):
        op.step(2.0)
        rec.append(len(op.kube.list("Node")))
        if op.settled():
            return tick
    return max_ticks


def ticks(op, rec: list, n: int) -> None:
    for _ in range(n):
        op.step(2.0)
        rec.append(len(op.kube.list("Node")))


_COUNTERS = (
    ("provisioning", "_claim_name_seq"),
    ("static", "_static_seq"),
    ("staticdrift", "_replacement_seq"),
)


def twin(scenario) -> dict:
    """Run `scenario(side)` on the reference, then on the port with its
    name counters where the reference's started; the records must agree."""
    start = {attr: getattr(getattr(REF, mod), attr)[0] for mod, attr in _COUNTERS}
    want = scenario(REF)
    for mod, attr in _COUNTERS:
        getattr(getattr(PORT, mod), attr)[0] = start[attr]
    got = scenario(PORT)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# tests/test_control_plane.py


def e2e(s) -> dict:
    op = operator(s)
    s.fixtures.reset_rng(5)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    for p in s.fixtures.make_generic_pods(10):
        op.kube.create("Pod", p)
    rec = []
    settle(op, rec)
    out = snapshot(s, op)
    conds = (s.objects.COND_LAUNCHED, s.objects.COND_REGISTERED, s.objects.COND_INITIALIZED)
    out["conditions"] = sorted(tuple(c.status.conditions.get(k) for k in conds) for c in op.kube.list("NodeClaim"))
    out["route"] = op.provisioner.last_solver_used
    out["ticks"] = rec
    return out


def scale_existing_first(s) -> dict:
    op = operator(s)
    s.fixtures.reset_rng(6)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    for p in s.fixtures.make_generic_pods(4):
        op.kube.create("Pod", p)
    rec = []
    settle(op, rec)
    op.kube.create("Pod", s.fixtures.pod(name="late", requests={"cpu": "10m", "memory": "10Mi"}))
    settle(op, rec)
    return {**snapshot(s, op), "ticks": rec}


def lifecycle_liveness(s) -> dict:
    op = operator(s)
    s.fixtures.reset_rng(7)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("Pod", s.fixtures.make_generic_pods(1)[0])
    op.cloud.create = lambda claim: (_ for _ in ()).throw(
        s.cptypes.CreateError("simulated capacity failure", reason="InsufficientCapacity")
    )
    rec = []
    ticks(op, rec, 2)
    claims_while_retrying = len(op.kube.list("NodeClaim"))
    op.clock.advance(op.opts.launch_ttl_seconds + 1)
    op.lifecycle.reconcile_all()
    op.lifecycle.reconcile_all()
    return {
        **snapshot(s, op),
        "ticks": rec,
        "retrying": claims_while_retrying,
        "liveness": len(op.recorder.for_reason("LivenessTimeout")),
    }


def termination_drain(s) -> dict:
    op = operator(s)
    s.fixtures.reset_rng(8)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    for p in s.fixtures.make_generic_pods(3):
        op.kube.create("Pod", p)
    rec = []
    settle(op, rec)
    node = op.kube.list("Node")[0]
    claim = op.kube.list("NodeClaim")[0]
    op.kube.delete("NodeClaim", claim.name)
    ticks(op, rec, 12)
    return {
        **snapshot(s, op),
        "ticks": rec,
        "gone": op.kube.try_get("Node", node.name) is None,
        "terminated": claim.status.provider_id in op.cloud.deleted,
    }


def pdb_blocks_eviction(s) -> dict:
    op = operator(s)
    s.fixtures.reset_rng(9)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("Pod", s.fixtures.pod(name="guarded", labels={"app": "db"}, requests={"cpu": "100m"}))
    rec = []
    settle(op, rec)
    stored = op.kube.get("Pod", "guarded")
    stored.phase = s.objects.PodPhase.RUNNING
    op.kube.update("Pod", stored)
    op.kube.create(
        "PodDisruptionBudget",
        s.objects.PodDisruptionBudget(
            metadata=s.fixtures.pod(name="pdb-db").metadata,
            selector=s.objects.LabelSelector(match_labels={"app": "db"}),
            max_unavailable="0",
        ),
    )
    node = op.kube.list("Node")[0]
    op.kube.delete("Node", node.name)
    for _ in range(5):
        op.termination.reconcile_all()
    guarded = op.kube.get("Pod", "guarded")
    return {
        **snapshot(s, op),
        "ticks": rec,
        "on_node": guarded.node_name == node.name,
        "terminating": guarded.terminating,
        "blocked": len(op.recorder.for_reason("EvictionBlocked")),
    }


def volume_topology(s) -> dict:
    op = operator(s)
    s.fixtures.reset_rng(10)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    sc = s.objects.StorageClass()
    sc.metadata.name = "zonal"
    sc.zones = ["test-zone-b"]
    op.kube.create("StorageClass", sc)
    pvc = s.objects.PersistentVolumeClaim(storage_class_name="zonal")
    pvc.metadata.name = "data"
    op.kube.create("PersistentVolumeClaim", pvc)
    p = s.fixtures.pod(name="zonal-pod", requests={"cpu": "100m"})
    p.volume_claims = ["data"]
    op.kube.create("Pod", p)
    rec = []
    settle(op, rec)
    node = op.kube.get("Node", op.kube.get("Pod", "zonal-pod").node_name)
    return {**snapshot(s, op), "ticks": rec, "zone": node.metadata.labels[s.labels.TOPOLOGY_ZONE_LABEL_KEY]}


def requirements_drift(s) -> dict:
    """The pool's zone moves: the claim drifts, and the disruption loop
    replaces its node (the replacement launched, initialized, the drifted
    node drained and removed by the Operator's own controllers)."""
    req = s.objects.NodeSelectorRequirement
    op = operator(s)
    s.fixtures.reset_rng(23)
    zone = s.labels.TOPOLOGY_ZONE_LABEL_KEY
    op.kube.create(
        "NodePool",
        s.fixtures.node_pool(name="default", requirements=[req(zone, s.objects.Operator.IN, ["test-zone-a"])]),
    )
    op.kube.create("Pod", s.fixtures.pod(name="w", requests={"cpu": "100m"}))
    rec = []
    settle(op, rec)
    claim = op.kube.list("NodeClaim")[0]
    pool = op.kube.get("NodePool", "default")
    pool.template.requirements = [req(zone, s.objects.Operator.IN, ["test-zone-b"])]
    op.kube.update("NodePool", pool)
    op.claim_conditions.reconcile_all()
    drifted = op.kube.get("NodeClaim", claim.name).status.conditions.get(s.objects.COND_DRIFTED)
    ticks(op, rec, 30)
    zones = sorted(n.metadata.labels.get(zone) for n in op.kube.list("Node"))
    return {**snapshot(s, op), "ticks": rec, "drifted": drifted, "zones": zones}


@pytest.mark.parametrize(
    "scenario",
    [
        e2e,
        scale_existing_first,
        lifecycle_liveness,
        termination_drain,
        pdb_blocks_eviction,
        volume_topology,
        requirements_drift,
    ],
    ids=lambda f: f.__name__,
)
def test_control_plane_twin(scenario):
    got = twin(scenario)
    if scenario is e2e:
        assert got["settled"] and got["claims"] and got["route"] == "tpu"
        assert all(c == ("True", "True", "True") for c in got["conditions"])
        assert all(node for _, node in got["bindings"])
    elif scenario is lifecycle_liveness:
        assert got["retrying"] and not got["claims"] and got["liveness"]
    elif scenario is termination_drain:
        assert got["gone"] and got["terminated"]
    elif scenario is pdb_blocks_eviction:
        assert got["on_node"] and not got["terminating"] and got["blocked"]
    elif scenario is volume_topology:
        assert got["zone"] == "test-zone-b"
    elif scenario is requirements_drift:
        assert got["drifted"] == "True" and got["zones"] == ["test-zone-b"]


# ---------------------------------------------------------------------------
# tests/test_chaos.py


def steady(s, n_pods: int):
    op = operator(s)
    s.fixtures.reset_rng(5)
    op.kube.create(
        "NodePool",
        s.fixtures.node_pool(
            name="default", budgets=[s.objects.Budget(nodes="100%")], consolidate_after_seconds=0.0
        ),
    )
    for i in range(n_pods):
        op.kube.create("Pod", s.fixtures.pod(name=f"w-{i}", requests={"cpu": "400m", "memory": "256Mi"}))
    rec = []
    settle(op, rec, max_ticks=60)
    for p in op.kube.list("Pod"):
        p.phase = s.objects.PodPhase.RUNNING
        op.kube.update("Pod", p)
    return op, rec


def no_runaway_scaleup(s) -> dict:
    op, rec = steady(s, 10)
    ticks(op, rec, 120)
    return {**snapshot(s, op), "ticks": rec}


def no_oscillation_after_consolidation(s) -> dict:
    op, rec = steady(s, 6)
    for i in range(6):
        op.kube.create("Pod", s.fixtures.pod(name=f"burst-{i}", requests={"cpu": "1500m"}))
    settle(op, rec, max_ticks=60)
    for i in range(6):
        op.kube.delete("Pod", f"burst-{i}")
    for _ in range(150):
        op.step(2.0)
        live = {p.name for p in op.kube.list("Pod")}
        for i in range(6):
            if f"w-{i}" not in live:
                op.kube.create("Pod", s.fixtures.pod(name=f"w-{i}", requests={"cpu": "400m", "memory": "256Mi"}))
        rec.append(len(op.kube.list("Node")))
    return {**snapshot(s, op), "ticks": rec}


@pytest.mark.parametrize("scenario", [no_runaway_scaleup, no_oscillation_after_consolidation], ids=lambda f: f.__name__)
def test_chaos_twin(scenario):
    got = twin(scenario)
    tail = got["ticks"][-40:]
    assert len(set(tail)) == 1, got["ticks"]
    assert all(node for _, node in got["bindings"])


# ---------------------------------------------------------------------------
# a consolidation Command carried through by the Operator's controllers


def consolidation_round_trip(s) -> dict:
    """An under-utilized fleet (the fixtures' `underutilized_operator`) on
    the kernel route, ticked until its node set holds still: the
    DisruptionController proposes a Command, the Validator confirms it after
    its TTL, the OrchestrationQueue launches any replacement, whose claim
    the lifecycle controller launches, registers and initializes, and the
    termination controller drains and removes the candidates' nodes."""
    kw = {"force_oracle": False} if s is REF else {"device": "cpu"}
    op = s.fixtures.underutilized_operator(6, sizes=[2, 8, 32], options=s.Options(tpu_min_pods=0), **kw)
    before = sorted(n.name for n in op.kube.list("Node"))
    rec = []
    ticks(op, rec, 45)  # the validation TTL, the drain and 10 still ticks
    def events(reason):
        return sorted((e.name, e.message) for e in op.recorder.for_reason(reason))

    return {
        **snapshot(s, op),
        "ticks": rec,
        "before": before,
        "disrupted": events("DisruptionTerminating"),
        "terminated": events("Terminated"),
    }


def test_consolidation_round_trip_removes_nodes():
    got = twin(consolidation_round_trip)
    assert len(got["nodes"]) < len(got["before"]), got["ticks"]
    assert got["disrupted"] and {n for n, _ in got["disrupted"]} <= {n for n, _ in got["terminated"]}
    assert len(set(got["ticks"][-10:])) == 1, got["ticks"]
    assert all(node in got["nodes"] for _, node in got["bindings"])
    assert got["settled"]
