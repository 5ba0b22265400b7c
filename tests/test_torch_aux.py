"""The port's auxiliary controllers and operator surface against the JAX
package's, on the CPU.

Twins of tests/test_aux_components.py: the cloud-provider decorators,
NodeOverlay, static capacity, the metrics controllers, the probe endpoints
(with `/debug/programs` reading the port's prewarm manifest),
`Operator.stop()`, profiling (with the port's `device_trace`, a
torch.profiler Chrome trace), leader election, `parallelize_until`,
concurrent termination, PodEvents, registration health, consistency and
hydration. Each scenario runs on both packages from the same seed (their
Operators with `force_oracle=True`: none of this runs device code), holds
the reference test's own checks on both, and requires the two to observe
the same values.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import types
import urllib.error
import urllib.request

import pytest

os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""

_MODULES = {
    "metrics": "metrics",
    "labels": "api.labels",
    "objects": "api.objects",
    "decorators": "cloudprovider.decorators",
    "kwok": "cloudprovider.kwok",
    "kube": "controllers.kube",
    "nodeoverlay": "controllers.nodeoverlay",
    "operator": "controllers.operator",
    "static": "controllers.static",
    "mc": "controllers.metrics_controllers",
    "probes": "controllers.probes",
    "nodepool_aux": "controllers.nodepool_aux",
    "provisioning": "controllers.provisioning",
    "options": "options",
    "events": "events",
    "klog": "logging",
    "profiling": "profiling",
    "leaderelection": "leaderelection",
    "workerpool": "utils.workerpool",
    "res": "utils.resources",
    "fixtures": "testing.fixtures",
}


def _side(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        pkg=pkg, **{alias: importlib.import_module(f"{pkg}.{mod}") for alias, mod in _MODULES.items()}
    )


REF = _side("karpenter_tpu")
PORT = _side("karpenter_tpu_torch")


def small_op(s, **kw):
    op = s.operator.Operator(clock=s.kube.FakeClock(), force_oracle=True, **kw)
    op.raw_cloud.types = s.kwok.construct_instance_types(sizes=[2, 8])
    op.raw_cloud._by_name = {it.name: it for it in op.raw_cloud.types}
    return op


def twin(scenario, *args):
    """The scenario's observations on the reference, then on the port
    (claim names from the same counter start); they must be equal."""
    start = REF.provisioning._claim_name_seq[0]
    static_start = REF.static._static_seq[0]
    want = scenario(REF, *args)
    PORT.provisioning._claim_name_seq[0] = start
    PORT.static._static_seq[0] = static_start
    got = scenario(PORT, *args)
    assert got == want
    return got


def get(port: int, path: str, timeout: float = 15):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# decorators, overlay, static capacity, metrics controllers


def metrics_decorator(s):
    op = small_op(s)
    labels = {"controller": "", "method": "get_instance_types", "provider": "kwok"}
    before = s.decorators.SPI_DURATION.count(labels)
    op.cloud.get_instance_types(s.fixtures.node_pool(name="default"))
    return s.decorators.SPI_DURATION.count(labels) - before


def overlay_price(s):
    op = small_op(s)
    np_ = s.fixtures.node_pool(name="default")
    op.kube.create("NodePool", np_)
    store = s.decorators.InstanceTypeStore()
    overlay_cloud = s.decorators.OverlayCloudProvider(op.cloud, store)
    ctrl = s.nodeoverlay.NodeOverlayController(op.kube, op.cloud, store)
    ov = s.nodeoverlay.NodeOverlay(
        metadata=s.objects.ObjectMeta(name="spot-discount"),
        requirements=[
            s.objects.NodeSelectorRequirement("karpenter.kwok.sh/instance-family", s.objects.Operator.IN, ["c"])
        ],
        price_adjustment="-50%",
    )
    op.kube.create("NodeOverlay", ov)
    assert ctrl.reconcile_all() == {}
    base = {it.name: it.offerings[0].price for it in op.cloud.get_instance_types(np_)}
    patched = {it.name: it.offerings[0].price for it in overlay_cloud.get_instance_types(np_)}
    for name, price in patched.items():
        assert price == pytest.approx(base[name] * (0.5 if name.startswith("c-") else 1.0))
    return base, patched


def overlay_capacity(s):
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    store = s.decorators.InstanceTypeStore()
    ctrl = s.nodeoverlay.NodeOverlayController(op.kube, op.cloud, store)
    meta = s.objects.ObjectMeta
    op.kube.create(
        "NodeOverlay", s.nodeoverlay.NodeOverlay(metadata=meta(name="add-gpu"), requirements=[], capacity={"example.com/gpu": 4000})
    )
    op.kube.create(
        "NodeOverlay", s.nodeoverlay.NodeOverlay(metadata=meta(name="conflicted"), price=1.0, price_adjustment="+10%")
    )
    problems = ctrl.reconcile_all()
    assert "conflicted" in problems
    patched = store.get("default")
    assert all(it.capacity.get("example.com/gpu") == 4000 for it in patched)
    return sorted(problems), sorted((it.name, sorted(it.capacity.items())) for it in patched)


def static_capacity(s):
    gates = s.options.FeatureGates(static_capacity=True)
    op = small_op(s, options=s.options.Options(feature_gates=gates))
    op.kube.create("NodePool", s.fixtures.node_pool(name="warmpool", replicas=3))
    prov = s.static.StaticProvisioning(op.kube, op.cluster, op.recorder)
    deprov = s.static.StaticDeprovisioning(op.kube, op.cluster, op.recorder)
    out = [prov.reconcile_all(), prov.reconcile_all(), len(op.kube.list("NodeClaim"))]
    op.run_until_settled(max_ticks=30)
    out.append(len(op.kube.list("Node")))
    np_ = op.kube.list("NodePool")[0]
    np_.replicas = 1
    op.kube.update("NodePool", np_)
    out.append(deprov.reconcile_all())
    for _ in range(12):
        op.step(2.0)
    out += [len(op.kube.list("Node")), prov.reconcile_all()]
    assert out == [3, 0, 3, 3, 2, 1, 0]
    return out, sorted(n.name for n in op.kube.list("Node"))


def metrics_controllers(s):
    op = small_op(s)
    s.fixtures.reset_rng(3)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default", limits={"cpu": "100"}))
    for p in s.fixtures.make_generic_pods(3):
        op.kube.create("Pod", p)
    op.run_until_settled(max_ticks=30)
    s.mc.NodeMetricsController(op.cluster).reconcile_all()
    s.mc.NodePoolMetricsController(op.kube).reconcile_all()
    s.mc.PodMetricsController(op.kube, op.cluster, op.clock).reconcile_all()
    node = op.kube.list("Node")[0]
    labels = {"node_name": node.name, "nodepool": "default", "resource_type": "cpu"}
    alloc = s.mc.NODE_ALLOCATABLE.value(labels)
    assert alloc > 0 and s.mc.POD_STATE.value({"phase": "Pending"}) >= 0
    op.kube.delete("NodeClaim", op.kube.list("NodeClaim")[0].name)
    for _ in range(12):
        op.step(2.0)
    s.mc.NodeMetricsController(op.cluster).reconcile_all()
    gone = s.mc.NODE_ALLOCATABLE.value(labels)
    assert gone == 0.0
    return alloc, gone


def pod_lifecycle_timing(s):
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("Pod", s.fixtures.pod(name="w", requests={"cpu": "500m"}))
    bound_before = s.mc.POD_BOUND_DURATION.count()
    decision_before = s.mc.POD_SCHEDULING_DECISION.count()
    op.clock.advance(5.0)
    op.pod_metrics.reconcile_all()
    labels = {"name": "w", "namespace": "default"}
    out = [s.mc.POD_UNBOUND_TIME.value(labels), s.mc.POD_UNSTARTED_TIME.value(labels)]
    assert op.run_until_settled(max_ticks=40) < 40
    op.pod_metrics.reconcile_all()
    out += [
        s.mc.POD_BOUND_DURATION.count() - bound_before,
        s.mc.POD_SCHEDULING_DECISION.count() - decision_before,
        s.mc.POD_UNBOUND_TIME.value(labels),
        s.mc.POD_UNSTARTED_TIME.value(labels),
    ]
    p = op.kube.get("Pod", "w")
    p.phase = s.objects.PodPhase.RUNNING
    op.kube.update("Pod", p)
    op.pod_metrics.reconcile_all()
    out.append(s.mc.POD_UNSTARTED_TIME.value(labels))
    assert out[0] >= 5.0 and out[1] >= 5.0 and out[2] == 1 and out[3] >= 1
    assert out[4] == 0.0 and out[5] > 0.0 and out[6] == 0.0
    return out


@pytest.mark.parametrize(
    "scenario",
    [metrics_decorator, overlay_price, overlay_capacity, static_capacity, metrics_controllers, pod_lifecycle_timing],
    ids=lambda f: f.__name__,
)
def test_controller_twin(scenario):
    twin(scenario)


# ---------------------------------------------------------------------------
# probes, stop(), profiling


def probe_endpoints(s, cache_dir):
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    srv = s.probes.ProbeServer(op.kube, op.cluster)
    srv.start()
    try:
        out = [get(srv.port, "/healthz"), get(srv.port, "/readyz")[0]]
        code, body = get(srv.port, "/metrics")
        out.append(code == 200 and "karpenter" in body)
        store = op.kube._store("NodeClaim")
        store["ghost"] = s.objects.NodeClaim(metadata=s.objects.ObjectMeta(name="ghost"))
        out.append(get(srv.port, "/readyz"))
        code, body = get(srv.port, "/debug/solves")
        out.append((code, type(json.loads(body)).__name__))
        code, body = get(srv.port, "/debug/solves/nope")
        out.append((code, json.loads(body)))
    finally:
        srv.stop()
    assert out[:4] == [(200, "ok"), 200, True, (503, "state not synced")]
    return out


def test_probe_endpoints_twin(tmp_path):
    twin(probe_endpoints, str(tmp_path))


def test_debug_programs_serves_the_prewarm_manifest(tmp_path, monkeypatch):
    """/debug/programs reads the port's manifest (solver/aot.py) and never
    builds: with a CPU prewarm recorded in the catalog directory, it
    serves every combo with its signature, first-launch ms and bytes."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.solver import aot

    monkeypatch.setattr(_build, "build_all", lambda: pytest.fail("the catalog built"))
    monkeypatch.setattr(aot, "default_cache_dir", lambda: str(tmp_path))
    op = small_op(PORT)
    srv = PORT.probes.ProbeServer(op.kube, op.cluster)
    srv.start()
    try:
        code, body = get(srv.port, "/debug/programs")
        assert code == 200 and json.loads(body)["programs"] == {}
        out = aot.prewarm(device="cpu", max_pods=64, include_sweeps=False, cache_dir=str(tmp_path))
        code, body = get(srv.port, "/debug/programs")
    finally:
        srv.stop()
    catalog = json.loads(body)
    assert code == 200 and catalog["device"] == "cpu" and catalog["cache_dir"] == str(tmp_path)
    assert set(catalog["programs"]) == set(out["combos"]) and catalog["programs"]
    for combo in catalog["programs"].values():
        assert combo["signature"] and combo["first_launch_ms"] >= 0 and combo["bytes"] > 0
        assert combo["build_seconds"] == 0


def operator_stop(s):
    op = s.operator.Operator(clock=s.kube.FakeClock(), force_oracle=True, options=s.options.Options(probe_port=0))
    port = op.probes.port
    op.stop()
    assert op.probes is None and s.klog.root._clock is None
    op2 = s.operator.Operator(clock=s.kube.FakeClock(), force_oracle=True, options=s.options.Options(probe_port=port))
    assert op2.probes.port == port
    op2.stop()
    return True


def test_operator_stop_twin():
    twin(operator_stop)


def profiling(s):
    stop = threading.Event()

    def busy_beaver():
        while not stop.is_set():
            sum(i * i for i in range(2000))

    t = threading.Thread(target=busy_beaver, daemon=True)
    t.start()
    try:
        sampler = s.profiling.profile_cpu(seconds=0.3, hz=200)
    finally:
        stop.set()
        t.join()
    assert sampler.total > 0 and "busy_beaver" in sampler.render_collapsed()
    top = sampler.render_top()
    assert "samples:" in top and "genexpr" in top
    s.profiling.heap_snapshot(keep_tracing=True)
    blob = [bytearray(64) for _ in range(2000)]
    heap = s.profiling.heap_snapshot()
    del blob
    import tracemalloc

    assert "bytes traced" in heap and "B " in heap and not tracemalloc.is_tracing()
    return True


def test_profiling_twin():
    twin(profiling)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The port's `device_trace` profiles the block with torch.profiler and
    writes a Chrome trace naming what ran (here the plain versions' CPU
    ops of a K1 screen; on the card, the kernels)."""
    from karpenter_tpu_torch.solver import aot

    sched, problem, _ = aot._representative("generic", "cpu")
    with PORT.profiling.device_trace(str(tmp_path)) as prof:
        sched._tables(problem)
    trace = json.loads((tmp_path / PORT.profiling.TRACE_NAME).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert names and any(n and n.startswith("aten::") for n in names)
    assert prof.key_averages()


def pprof_gate(s):
    op = small_op(s)
    off = s.probes.ProbeServer(op.kube, op.cluster)
    off.start()
    try:
        closed = get(off.port, "/debug/pprof/profile?seconds=0.1")[0]
    finally:
        off.stop()
    on = s.probes.ProbeServer(op.kube, op.cluster, enable_profiling=True)
    on.start()
    try:
        code, body = get(on.port, "/debug/pprof/profile?seconds=0.2&top=1")
        prof = code == 200 and "samples:" in body
        code, body = get(on.port, "/debug/pprof/heap")
        heap = code == 200 and "bytes traced" in body
        bad = [get(on.port, f"/debug/pprof/profile?seconds={q}")[0] for q in ("x", "-1")]
    finally:
        on.stop()
    assert closed == 404 and prof and heap and bad == [400, 400]
    return closed, prof, heap, bad


def test_pprof_gate_twin():
    twin(pprof_gate)


# ---------------------------------------------------------------------------
# leader election


def lease_lifecycle(s, tmp):
    clock = s.kube.FakeClock()
    lease = os.path.join(tmp, f"{s.pkg}-lease.json")
    mk = s.leaderelection.LeaderElector
    a = mk(lease, identity="a", lease_duration=15, renew_period=5, clock=clock)
    b = mk(lease, identity="b", lease_duration=15, renew_period=5, clock=clock)
    out = [a.ensure(), b.ensure(), a.holder(), b.holder()]
    for _ in range(5):
        clock.advance(5.0)
        out += [a.ensure(), b.ensure()]
    clock.advance(15.1)
    out += [b.ensure(), b.holder(), a.ensure(), a.is_leader]
    b.release()
    out.append(a.ensure())
    assert out[:4] == [True, False, "a", "a"] and out[-5:] == [True, "b", False, False, True]
    return out


def lease_fences_stale_holder(s, tmp):
    clock = s.kube.FakeClock()
    a = s.leaderelection.LeaderElector(
        os.path.join(tmp, f"{s.pkg}-l.json"), identity="a", lease_duration=15, renew_period=5, clock=clock
    )
    out = [a.ensure(), a.is_leader]
    clock.advance(15.1)
    out.append(a.is_leader)
    assert out == [True, True, False]
    return out


def standby_until_leader(s, tmp):
    lease = os.path.join(tmp, f"{s.pkg}-op-lease.json")
    clock = s.kube.FakeClock()

    def opts():
        return s.options.Options(
            leader_elect_lease_path=lease, leader_elect_lease_seconds=30, leader_elect_renew_seconds=5
        )

    leader = s.operator.Operator(clock=clock, force_oracle=True, options=opts())
    standby = s.operator.Operator(clock=clock, force_oracle=True, options=opts())
    leader.step()
    standby.step()
    out = [leader.elector.is_leader, standby.elector.is_leader]
    standby.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    s.fixtures.reset_rng(5)
    for p in s.fixtures.make_generic_pods(4):
        standby.kube.create("Pod", p)
    for _ in range(20):
        leader.step(0.0)
        standby.step(2.0)
    out.append(len(standby.kube.list("Node")))
    leader.stop()
    for _ in range(30):
        standby.step(2.0)
    out += [standby.elector.is_leader, sorted(n.name for n in standby.kube.list("Node"))]
    standby.stop()
    assert out[:3] == [True, False, 0] and out[3] and out[4]
    return out


def short_lease_challenger(s, tmp):
    clock = s.kube.FakeClock()
    lease = os.path.join(tmp, f"{s.pkg}-lease2.json")
    mk = s.leaderelection.LeaderElector
    long_ = mk(lease, identity="long", lease_duration=60, renew_period=20, clock=clock)
    short = mk(lease, identity="short", lease_duration=15, renew_period=5, clock=clock)
    out = [long_.ensure()]
    clock.advance(16.0)
    out += [short.ensure(), long_.is_leader]
    clock.advance(60.0)
    out.append(short.ensure())
    assert out == [True, False, True, True]
    return out


@pytest.mark.parametrize(
    "scenario",
    [lease_lifecycle, lease_fences_stale_holder, standby_until_leader, short_lease_challenger],
    ids=lambda f: f.__name__,
)
def test_leader_election_twin(scenario, tmp_path):
    twin(scenario, str(tmp_path))


# ---------------------------------------------------------------------------
# the worker pool and concurrent termination


def parallelize(s):
    seen = set()
    lock = threading.Lock()

    def fn(i):
        with lock:
            seen.add(i)
        if i % 3 == 0:
            raise RuntimeError(f"boom-{i}")

    errs = s.workerpool.parallelize_until(4, 10, fn)
    out = [sorted(seen), [i for i, e in enumerate(errs) if e is not None], [str(e) for e in errs if e]]
    seen.clear()
    errs = s.workerpool.parallelize_until(1, 4, fn)
    out += [sorted(seen), [e is None for e in errs]]
    assert out[1] == [0, 3, 6, 9] and out[3] == [0, 1, 2, 3]
    return out


def concurrent_termination(s):
    op = small_op(s, options=s.options.Options(termination_workers=8))
    assert op.termination.workers == 8
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    s.fixtures.reset_rng(9)
    for p in s.fixtures.make_generic_pods(12):
        op.kube.create("Pod", p)
    op.run_until_settled(max_ticks=40)
    nodes = sorted(n.name for n in op.kube.list("Node"))
    assert nodes
    for n in nodes:
        op.kube.delete("Node", n)
    rec = []
    for _ in range(40):
        op.step(2.0)
        rec.append(len(op.kube.list("Node")))
        if not op.kube.list("Node"):
            break
    assert not op.kube.list("Node")
    return nodes, rec


def shared_pdb_eviction(s):
    op = small_op(s, options=s.options.Options(termination_workers=8))
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    s.fixtures.reset_rng(9)
    o = s.objects
    for i in range(2):
        op.kube.create(
            "Pod",
            s.fixtures.pod(
                name=f"guarded-{i}",
                labels={"app": "guarded"},
                requests={"cpu": "100m"},
                pod_anti_requirements=[
                    o.PodAffinityTerm(
                        topology_key=s.labels.HOSTNAME_LABEL_KEY,
                        label_selector=o.LabelSelector(match_labels={"app": "guarded"}),
                    )
                ],
            ),
        )
    op.run_until_settled(max_ticks=40)
    nodes = op.kube.list("Node")
    assert len(nodes) == 2
    for p in op.kube.list("Pod"):
        p.phase = o.PodPhase.RUNNING
        op.kube.update("Pod", p)
    op.kube.create(
        "PodDisruptionBudget",
        o.PodDisruptionBudget(
            metadata=o.ObjectMeta(name="guard"),
            selector=o.LabelSelector(match_labels={"app": "guarded"}),
            max_unavailable="1",
        ),
    )
    for n in nodes:
        op.kube.delete("Node", n.name)
    op.termination.reconcile_all()
    terminating = [p for p in op.kube.list("Pod") if p.terminating]
    assert len(terminating) == 1
    return len(terminating)


@pytest.mark.parametrize(
    "scenario", [parallelize, concurrent_termination, shared_pdb_eviction], ids=lambda f: f.__name__
)
def test_workers_twin(scenario):
    twin(scenario)


# ---------------------------------------------------------------------------
# PodEvents, registration health, consistency, hydration


def _settled_claim_op(s, consolidate_after: float = 30.0):
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default", consolidate_after_seconds=consolidate_after))
    for i in range(2):
        op.kube.create("Pod", s.fixtures.pod(name=f"w-{i}", requests={"cpu": "500m", "memory": "512Mi"}))
    assert op.run_until_settled(max_ticks=40) < 40
    for p in op.kube.list("Pod"):
        p.phase = s.objects.PodPhase.RUNNING
        op.kube.update("Pod", p)
    (claim,) = op.kube.list("NodeClaim")
    assert claim.status.node_name
    return op, claim.name


def podevents_churn(s):
    op, name = _settled_claim_op(s)
    node_name = op.kube.get("NodeClaim", name).status.node_name
    op.clock.advance(60.0)
    op.kube.delete("Pod", "w-0")
    op.kube.create("Pod", s.fixtures.pod(name="w-new", requests={"cpu": "500m"}))
    op.kube.bind("w-new", node_name)
    op.clock.advance(1.0)
    op.pod_events.reconcile_all()
    op.claim_conditions.reconcile_all()
    claim = op.kube.get("NodeClaim", name)
    out = [claim.status.last_pod_event_time, claim.status.conditions.get(s.objects.COND_CONSOLIDATABLE)]
    op.clock.advance(31.0)
    op.claim_conditions.reconcile_all()
    out.append(op.kube.get("NodeClaim", name).status.conditions.get(s.objects.COND_CONSOLIDATABLE))
    assert out[0] >= 60.0 and out[1:] == ["False", "True"]
    return out


def podevents_transitions(s):
    op, name = _settled_claim_op(s)

    def stamp():
        return op.kube.get("NodeClaim", name).status.last_pod_event_time

    out = [stamp()]
    op.clock.advance(20.0)
    p = op.kube.get("Pod", "w-0")
    p.metadata.labels["x"] = "y"
    op.kube.update("Pod", p)
    out.append(stamp())
    p = op.kube.get("Pod", "w-0")
    p.phase = s.objects.PodPhase.SUCCEEDED
    op.kube.update("Pod", p)
    out.append(stamp())
    op.clock.advance(5.0)
    p = op.kube.get("Pod", "w-1")
    p.phase = s.objects.PodPhase.FAILED
    op.kube.update("Pod", p)
    out.append(stamp())
    op.clock.advance(11.0)
    op.kube.delete("Pod", "w-1")
    out.append(stamp())
    assert out[1] == out[0] < out[2] == out[3] < out[4]
    return out


def podevents_daemonset_and_eviction(s):
    op, name = _settled_claim_op(s)
    node_name = op.kube.get("NodeClaim", name).status.node_name
    t0 = op.kube.get("NodeClaim", name).status.last_pod_event_time
    op.clock.advance(20.0)
    ds = s.fixtures.pod(name="ds-0", requests={"cpu": "10m"})
    ds.metadata.annotations["karpenter.sh/daemonset"] = "true"
    op.kube.create("Pod", ds)
    op.kube.bind("ds-0", node_name)
    t1 = op.kube.get("NodeClaim", name).status.last_pod_event_time
    p = op.kube.get("Pod", "w-0")
    p.terminating = True
    op.kube.update("Pod", p)
    t2 = op.kube.get("NodeClaim", name).status.last_pod_event_time
    assert t1 == t0 < t2
    return t0, t1, t2


def reghealth_thresholds(s):
    cond = s.objects.COND_NODE_REGISTRATION_HEALTHY
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    rh = s.nodepool_aux.RegistrationHealth(op.kube)
    out = [rh.status("default")]
    for ok in (True, False, False):
        rh.record_launch("default", ok)
        out += [rh.status("default"), op.kube.get("NodePool", "default").conditions[cond]]
    out.append(rh.dry_run("other", False))
    assert out == [rh.UNKNOWN, rh.HEALTHY, "True", rh.HEALTHY, "True", rh.UNHEALTHY, "False", rh.HEALTHY]
    return out


def reghealth_hydration(s):
    cond = s.objects.COND_NODE_REGISTRATION_HEALTHY
    op = small_op(s)
    np_ = s.fixtures.node_pool(name="default")
    np_.conditions[cond] = "False"
    op.kube.create("NodePool", np_)
    rh = s.nodepool_aux.RegistrationHealth(op.kube)
    rh.reconcile_all()
    out = [rh.status("default")]
    np_ = op.kube.get("NodePool", "default")
    np_.template.labels["changed"] = "yes"
    op.kube.update("NodePool", np_)
    rh.reconcile_all()
    out += [rh.status("default"), op.kube.get("NodePool", "default").conditions[cond]]
    assert out == [rh.UNHEALTHY, rh.UNKNOWN, "Unknown"]
    return out


def reghealth_registration(s):
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("Pod", s.fixtures.pod(name="w", requests={"cpu": "500m"}))
    ticks = op.run_until_settled(max_ticks=40)
    got = op.kube.get("NodePool", "default").conditions.get(s.objects.COND_NODE_REGISTRATION_HEALTHY)
    assert ticks < 40 and got == "True"
    return ticks, got


def consistency_nodeshape(s):
    cond = s.objects.COND_CONSISTENT_STATE_FOUND
    cpu = s.res.CPU
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("Pod", s.fixtures.pod(name="w", requests={"cpu": "500m"}))
    assert op.run_until_settled(max_ticks=40) < 40
    (claim,) = op.kube.list("NodeClaim")
    name = claim.name
    out = [op.consistency.reconcile_all(), op.kube.get("NodeClaim", name).status.conditions[cond]]
    node = op.kube.get("Node", claim.status.node_name)
    node.capacity[cpu] = claim.status.capacity[cpu] // 2
    op.kube.update("Node", node)
    out += [op.consistency.reconcile_all(), op.kube.get("NodeClaim", name).status.conditions[cond]]
    node = op.kube.get("Node", claim.status.node_name)
    node.capacity[cpu] = claim.status.capacity[cpu] * 95 // 100
    op.kube.update("Node", node)
    out.append(op.consistency.reconcile_all())
    node = op.kube.get("Node", claim.status.node_name)
    node.capacity["vendor/gpu"] = 0
    claim = op.kube.get("NodeClaim", name)
    claim.status.capacity["vendor/gpu"] = 100
    op.kube.update("NodeClaim", claim)
    op.kube.update("Node", node)
    out.append(op.consistency.reconcile_all())
    assert out[0] == [] and out[1] == "True" and "50.0% of expected" in out[2][0]
    assert out[3] == "False" and out[4] == [] and out[5] == []
    return out


def hydration(s):
    key = s.labels.NODECLASS_LABEL_KEY
    op = small_op(s)
    op.kube.create("NodePool", s.fixtures.node_pool(name="default"))
    op.kube.create("Pod", s.fixtures.pod(name="w", requests={"cpu": "500m"}))
    assert op.run_until_settled(max_ticks=40) < 40
    (claim,) = op.kube.list("NodeClaim")
    claim.metadata.labels.pop(key, None)
    op.kube.update("NodeClaim", claim)
    op.hydration.reconcile_all()
    claim = op.kube.get("NodeClaim", claim.name)
    node = op.kube.get("Node", claim.status.node_name)
    out = [claim.metadata.labels[key], node.metadata.labels[key], claim.node_class_ref]
    assert out[0] == out[1] == out[2]
    return out


@pytest.mark.parametrize(
    "scenario",
    [
        podevents_churn,
        podevents_transitions,
        podevents_daemonset_and_eviction,
        reghealth_thresholds,
        reghealth_hydration,
        reghealth_registration,
        consistency_nodeshape,
        hydration,
    ],
    ids=lambda f: f.__name__,
)
def test_nodeclaim_aux_twin(scenario):
    twin(scenario)


def test_nodepool_hash_equals_reference():
    """nodepool_hash (the drift hash) is the reference's for the same pool."""
    from karpenter_tpu.controllers import nodeclaim_aux as rnc
    from karpenter_tpu_torch.controllers import nodeclaim_aux as pnc

    REF.fixtures.reset_rng(4)
    PORT.fixtures.reset_rng(4)
    for kw in ({}, {"limits": {"cpu": "100"}}, {"consolidate_after_seconds": 30.0}):
        r = REF.fixtures.node_pool(name="default", **kw)
        p = PORT.fixtures.node_pool(name="default", **kw)
        assert pnc.nodepool_hash(p) == rnc.nodepool_hash(r)
    assert pnc.NODEPOOL_HASH_VERSION == rnc.NODEPOOL_HASH_VERSION
