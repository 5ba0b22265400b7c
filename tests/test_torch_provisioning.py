"""The port's Provisioner (plain versions on the CPU) against the JAX
package's, on one cluster.

Each cluster is built with the reference's control plane objects and
carried across with `convert.cluster` (objects as `api.codec.to_jsonable`
dicts, so both sides hold the same names and uids). Both sides then run
`Provisioner.reconcile(ignore_batcher=True)` with `Options(tpu_min_pods=0)`
(the two packages' crossover defaults differ), once on the kernels and
once with `force_oracle=True`, and must agree on the `ProvisioningResult`
(`skipped`, `reason`, `fuzz.results_snapshot` of its Results), the created
NodeClaims compared without their names (each package names claims from
its own counter, and the claims' synthetic hostnames likewise), the bound
pods, `last_solver_used` and the FailedScheduling events.
"""

import copy
import json
import os

import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.api import labels as well_known
from karpenter_tpu.api.codec import to_jsonable
from karpenter_tpu.api.objects import NodeSelectorRequirement, Operator, PersistentVolumeClaim, StorageClass
from karpenter_tpu.cloudprovider.kwok import KwokCloudProvider, construct_instance_types
from karpenter_tpu.controllers.kube import FakeClock, SimKube
from karpenter_tpu.controllers import provisioning as rprovisioning
from karpenter_tpu.controllers.provisioning import Batcher as RBatcher
from karpenter_tpu.controllers.provisioning import Provisioner as RProvisioner
from karpenter_tpu.controllers.state import Cluster, wire_informers
from karpenter_tpu.options import Options as ROptions
from karpenter_tpu.testing import fixtures, fuzz
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api import codec as pcodec
from karpenter_tpu_torch.controllers import kube as pkube
from karpenter_tpu_torch.controllers import provisioning as pprovisioning
from karpenter_tpu_torch.controllers.provisioning import Batcher as PBatcher
from karpenter_tpu_torch.controllers.provisioning import Provisioner as PProvisioner
from karpenter_tpu_torch.options import Options as POptions


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


def _types():
    return construct_instance_types(sizes=[2, 8, 32])


def ref_world(objects=(), its=None):
    """A reference SimKube with a wired Cluster cache, a FakeClock and a
    KWOK provider; `objects` are (kind, object) pairs created in order."""
    clock = FakeClock()
    kube = SimKube(clock)
    cluster = Cluster(clock)
    wire_informers(kube, cluster)
    cloud = KwokCloudProvider(kube, clock, instance_types=its if its is not None else _types())
    for kind, obj in objects:
        kube.create(kind, obj)
    return kube, cluster, cloud, clock


def objects_of(kube, cluster) -> list:
    """The store's objects as JSON-able dicts: pools, storage, each state
    node's claim before its node (in the cache's order), then pods."""
    out = [to_jsonable(o) for kind in ("NodePool", "StorageClass", "PersistentVolumeClaim") for o in kube.list(kind)]
    for sn in cluster.state_nodes():
        if sn.node_claim is not None:
            out.append(to_jsonable(kube.get("NodeClaim", sn.node_claim.name)))
        if sn.node is not None:
            out.append(to_jsonable(kube.get("Node", sn.node.name)))
    return out + [to_jsonable(p) for p in kube.list("Pod")]


def port_world(kube, cluster, cloud, clock):
    its = [to_jsonable(it) for it in cloud.types]
    return convert.cluster(objects_of(kube, cluster), its, clock.now())


def _claim_view(d: dict) -> str:
    """A created NodeClaim without what each package names on its own: the
    object's name, uid, version and the synthetic hostname."""
    d = copy.deepcopy(d)
    for k in ("name", "uid", "resource_version", "creation_timestamp"):
        d["metadata"].pop(k, None)
    d["metadata"]["labels"].pop(well_known.HOSTNAME_LABEL_KEY, None)
    for r in d["requirements"]:
        if r["key"] == well_known.HOSTNAME_LABEL_KEY:
            r["values"] = []
    return json.dumps(d, sort_keys=True)


def _events(recorder) -> list:
    return sorted((e.kind, e.name, e.type, e.reason, e.message) for e in recorder.for_reason("FailedScheduling"))


def outcome(prov, result, codec_to_jsonable) -> dict:
    res = result.results
    pods = prov.kube.list("Pod")
    return {
        "skipped": result.skipped,
        "reason": result.reason,
        "snapshot": fuzz.results_snapshot(res, pods) if res is not None else None,
        "claims": sorted(_claim_view(codec_to_jsonable(c)) for c in result.created_claims),
        "bound": dict(result.bound_pods),
        "solver": prov.last_solver_used,
        "events": _events(prov.recorder),
    }


def reconcile_both(make, force_oracle: bool, **kw):
    """Build the reference cluster (`make()` -> ref_world), carry it across,
    and reconcile once on each side."""
    kube, cluster, cloud, clock = make()
    w = port_world(kube, cluster, cloud, clock)
    rp = RProvisioner(kube, cluster, cloud, clock, ROptions(tpu_min_pods=0), force_oracle=force_oracle)
    pp = PProvisioner(w.kube, w.cluster, w.cloud, w.clock, POptions(tpu_min_pods=0), force_oracle=force_oracle,
                      device="cpu")
    # both packages name claims "<pool>-<n>" from a module counter; the
    # carried cluster holds the reference counter's names, so the port's
    # counter starts where the reference's stands
    pprovisioning._claim_name_seq[0] = rprovisioning._claim_name_seq[0]
    want = outcome(rp, rp.reconcile(ignore_batcher=True, **kw), to_jsonable)
    got = outcome(pp, pp.reconcile(ignore_batcher=True, **kw), pcodec.to_jsonable)
    assert got == want
    return got, pp


def pending_world():
    """A default pool and a pending batch: diverse pods, one no type fits
    (a FailedScheduling event from the solve), one whose selector fails
    validation (an event from get_pending_pods)."""
    fixtures.reset_rng(5)
    pods = fixtures.make_diverse_pods(24)
    for i, p in enumerate(pods):  # the mix's families reuse names
        p.metadata.name = f"diverse-{i}"
    pods.append(fixtures.pod(name="too-big", requests={"cpu": "1000"}))
    pods.append(fixtures.pod(name="bad-selector", requests={"cpu": "100m"},
                             node_selector={"kubernetes.io/bad": "x"}))
    return ref_world([("NodePool", fixtures.node_pool(name="default"))] + [("Pod", p) for p in pods])


def existing_world():
    """A settled under-utilized fleet (ready nodes, bound riders) plus a
    pending batch that fits on the existing nodes and beyond."""
    op = fixtures.underutilized_operator(
        6, seed=7, sizes=[2, 8, 32], rider_requests={"cpu": "400m", "memory": "128Mi"},
        seed_requests={"cpu": "700m", "memory": "512Mi"}, force_oracle=True,
    )
    fixtures.reset_rng(9)
    for p in fixtures.make_generic_pods(16):
        op.kube.create("Pod", p)
    return op.kube, op.cluster, op.raw_cloud, op.clock


@pytest.mark.parametrize("force_oracle", [False, True], ids=["kernels", "oracle"])
def test_pending_batch_reconcile(force_oracle):
    got, pp = reconcile_both(pending_world, force_oracle)
    assert not got["skipped"] and got["claims"]
    assert got["solver"] == ("oracle" if force_oracle else "tpu")
    messages = [e[4] for e in got["events"]]
    assert any("kubernetes.io/bad" in m or "restricted" in m for m in messages), messages
    assert any(e[1] == "too-big" for e in got["events"])
    if not force_oracle:
        assert pp.last_scheduler.used_tpu and pp.last_scheduler.tpu.last_odometer["steps"] > 0
        assert {"build_inputs", "topology", "kernel", "create_node_claims"} <= set(pp.last_phases)


@pytest.mark.parametrize("force_oracle", [False, True], ids=["kernels", "oracle"])
def test_existing_nodes_reconcile(force_oracle):
    got, _ = reconcile_both(existing_world, force_oracle)
    assert got["bound"], "pending pods should land on the ready existing nodes"
    assert got["solver"] == ("oracle" if force_oracle else "tpu")


def test_batcher_window():
    """tests/test_control_plane.py:207 on both Batchers, step for step."""
    rclock, pclock = FakeClock(), pkube.FakeClock()
    rb, pb = RBatcher(rclock, 1.0, 10.0), PBatcher(pclock, 1.0, 10.0)
    trace = []

    def both(fn):
        trace.append((fn(rb, rclock), fn(pb, pclock)))

    both(lambda b, c: b.ready())
    both(lambda b, c: b.trigger("a"))
    both(lambda b, c: b.ready())
    both(lambda b, c: (c.advance(0.5), b.trigger("b"), c.advance(1.1), b.ready()))
    both(lambda b, c: b.reset())
    for i in range(100):
        both(lambda b, c: (b.trigger(f"t{i}"), c.advance(0.2), b.ready()))
        if trace[-1][0][-1]:
            break
    both(lambda b, c: b.ready())
    assert all(r == p for r, p in trace), trace
    assert trace[-1] == (True, True) and trace[3][0][-1] is True


def test_batcher_gates_reconcile():
    """Without `ignore_batcher` a reconcile waits for the batch window on
    both sides, then runs."""
    kube, cluster, cloud, clock = pending_world()
    w = port_world(kube, cluster, cloud, clock)
    rp = RProvisioner(kube, cluster, cloud, clock, ROptions(tpu_min_pods=0), force_oracle=True)
    pp = PProvisioner(w.kube, w.cluster, w.cloud, w.clock, POptions(tpu_min_pods=0), force_oracle=True)
    for prov, clk in ((rp, clock), (pp, w.clock)):
        first = prov.reconcile()
        assert (first.skipped, first.reason) == (True, "batch window open")
        for p in prov.kube.list("Pod"):
            prov.trigger_pod(p)
        assert prov.reconcile().skipped
        clk.advance(1.5)
    assert outcome(pp, pp.reconcile(), pcodec.to_jsonable) == outcome(rp, rp.reconcile(), to_jsonable)


def _zonal_world(claim_name="data", with_pvc=True):
    sc = StorageClass()
    sc.metadata.name = "zonal"
    sc.zones = ["test-zone-b"]
    pvc = PersistentVolumeClaim(storage_class_name="zonal")
    pvc.metadata.name = "data"
    p = fixtures.pod(name="zonal-pod", requests={"cpu": "100m"})
    p.volume_claims = [claim_name]
    fixtures.reset_rng(10)
    objects = [("NodePool", fixtures.node_pool(name="default")), ("StorageClass", sc)]
    if with_pvc:
        objects.append(("PersistentVolumeClaim", pvc))
    # a supported batch beside it, so the volume pod is a continuation
    objects += [("Pod", q) for q in fixtures.make_generic_pods(6)] + [("Pod", p)]
    return ref_world(objects)


@pytest.mark.parametrize("force_oracle", [False, True], ids=["kernels", "oracle"])
def test_volume_topology_injection(force_oracle):
    """tests/test_control_plane.py:170: the PVC's StorageClass zone lands
    on the volume pod's claim; on the kernels the pod is continued on the
    oracle."""
    got, pp = reconcile_both(_zonal_world, force_oracle)
    zonal = [
        json.loads(c) for c in got["claims"]
        if any(r["key"] == well_known.TOPOLOGY_ZONE_LABEL_KEY and r["values"] == ["test-zone-b"]
               for r in json.loads(c)["requirements"])
    ]
    assert zonal
    assert "zonal-pod" in {n for claim in got["snapshot"][0] for n in claim[0]}
    if not force_oracle:
        assert pp.last_scheduler.fallback_kind == "partition_continuation"


def test_missing_pvc_blocks_pod():
    """tests/test_control_plane.py:193."""
    got, _ = reconcile_both(lambda: _zonal_world("missing", with_pvc=False), False)
    assert ("Pod", "zonal-pod", "Warning", "FailedScheduling",
            "missing persistent volume claim 'missing'") in got["events"]
    assert "zonal-pod" not in {n for claim in got["snapshot"][0] for n in claim[0]}


def test_nodepool_opt_out_selector():
    """tests/test_control_plane.py:323: the only pod opts out, so nothing
    is pending."""
    optout = fixtures.pod(
        name="optout",
        requests={"cpu": "500m"},
        node_requirements=[NodeSelectorRequirement(well_known.NODEPOOL_LABEL_KEY, Operator.DOES_NOT_EXIST, [])],
    )
    got, _ = reconcile_both(
        lambda: ref_world([("NodePool", fixtures.node_pool(name="default")), ("Pod", optout)]), False
    )
    assert (got["skipped"], got["reason"]) == (True, "no pending pods")
    assert not got["claims"]
    assert got["events"] == [("Pod", "optout", "Warning", "FailedScheduling",
                              "pod opted out of provisioning (nodepool DoesNotExist)")]


def test_default_device_without_cuda_raises_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = port_world(*pending_world())
    with pytest.raises(RuntimeError, match="CUDA"):
        PProvisioner(w.kube, w.cluster, w.cloud, w.clock)
    # the oracle-only Provisioner runs no device code
    assert PProvisioner(w.kube, w.cluster, w.cloud, w.clock, force_oracle=True).device is None


def test_crossover_is_one_value():
    """The card's crossover (`solver.oracle.TPU_MIN_PODS`) is the default of
    both option sets; the environment overrides the operator's."""
    from karpenter_tpu_torch.solver.oracle import SchedulerOptions

    assert POptions().tpu_min_pods == SchedulerOptions().tpu_min_pods
    assert POptions.from_env({"KARPENTER_TPU_MIN_PODS": "17"}).tpu_min_pods == 17


def test_launch_price_memo_keeps_the_order():
    """`InstanceTypes.order_by_price` with a price memo shared across calls
    (as `create_node_claims` shares one across a round's claims) orders the
    types exactly as without it."""
    from karpenter_tpu_torch.api.objects import Operator as POp
    from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types as port_types
    from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
    from karpenter_tpu_torch.scheduling import Requirement, Requirements

    zone, cap = well_known.TOPOLOGY_ZONE_LABEL_KEY, well_known.CAPACITY_TYPE_LABEL_KEY
    cases = [
        [],
        [Requirement(zone, POp.IN, ["test-zone-a"])],
        [Requirement(zone, POp.IN, ["test-zone-b", "test-zone-c"]), Requirement(cap, POp.IN, ["spot"])],
        [Requirement(zone, POp.NOT_IN, ["test-zone-a"])],
        [Requirement(cap, POp.IN, ["on-demand"]), Requirement(well_known.ARCH_LABEL_KEY, POp.IN, ["arm64"])],
        [Requirement(zone, POp.IN, ["test-zone-d"]), Requirement(well_known.HOSTNAME_LABEL_KEY, POp.IN, ["a"])],
        [Requirement(zone, POp.IN, ["test-zone-d"]), Requirement(well_known.HOSTNAME_LABEL_KEY, POp.IN, ["b"])],
        [Requirement(zone, POp.IN, ["nowhere"])],
    ]
    its = port_types(sizes=[2, 8, 32])
    prices: dict = {}
    for reqs in cases + cases[::-1]:
        want = [it.name for it in InstanceTypes(its).order_by_price(Requirements(reqs))]
        got = [it.name for it in InstanceTypes(its).order_by_price(Requirements(reqs), prices)]
        assert got == want
