"""The port's solver sidecar (karpenter_tpu_torch/solver/service.py) against
the JAX package's protocol and decisions.

The port's server solves on the CPU here (`SolverServer(..., device="cpu")`,
the kernels' plain versions) and speaks the reference's wire protocol:

- the port's request bytes equal the reference's for the same problem;
- a sidecar solve with existing nodes is decision-identical to the port's
  in-process solve and to the reference's (tests/test_service.py:116);
- a delta with churn equals a full snapshot of the churned world and the
  in-process solve (tests/test_service.py:395), and a same-epoch repeat
  hits the server's table cache;
- the reference's `SolverClient` and the C++ client built from
  native/solver_client.cc both get answers from the port's server
  (tests/test_service.py:191);
- the fault envelope: an ERROR frame that keeps the connection serving,
  an oversized frame drained, the graceful drain, the admission RETRY
  (tests/test_service_faults.py:192, :222, :360, :1019), and a failure of
  the device answered as an ERROR that names it, never re-solved on the
  oracle;
- tests/test_fleet.py:107's matrix at 2, 5 and 8 lanes through the port's
  server with a fleet window, each lane equal to the port's solo solve,
  and the 2-lane window also to the reference's.

Every test records the port's protocol events (`analysis.protorec`) and
hands them to both judges, the reference's `proto.check_refinement` and the
port's (`karpenter_tpu_torch.analysis.proto`), which must agree; and runs
under the port's race witness (`analysis.racert`), which must see no
lock-order inversion and no uncaught thread exception.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import struct
import subprocess
import tempfile
import threading
import time

import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.analysis import proto
from karpenter_tpu.api import labels as ref_wk
from karpenter_tpu.cloudprovider.kwok import construct_instance_types as ref_types
from karpenter_tpu.solver import service as ref_service
from karpenter_tpu.solver.nodes import StateNodeView as RefView
from karpenter_tpu.solver.oracle import SchedulerOptions as RefOptions
from karpenter_tpu.solver.topology import Topology as RefTopology
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.testing import fixtures as ref_fixtures
from karpenter_tpu_torch import tracing, wire
from karpenter_tpu_torch.analysis import proto as port_proto
from karpenter_tpu_torch.analysis import protorec, racert
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.solver import epochs, fleet, service
from karpenter_tpu_torch.solver.hybrid import solve_in_process
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.service import (
    KIND_ERROR,
    KIND_PING,
    KIND_PONG,
    KIND_SOLVE,
    MAGIC,
    SolverClient,
    SolverError,
    SolverServer,
)
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.testing import fixtures

WIRE_TIMEOUT = 120.0
PROFILES = [f"{k}00m" for k in range(1, 9)]


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    old = os.environ.get("KARPENTER_COMPILATION_CACHE_DIR")
    os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""
    jaxsetup.ensure_compilation_cache()
    yield
    if old is None:
        del os.environ["KARPENTER_COMPILATION_CACHE_DIR"]
    else:
        os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = old
    jaxsetup.ensure_compilation_cache()


@pytest.fixture(autouse=True)
def recorder():
    """The port's protocol recorder and race witness around each test: its
    trace must be an accepted behavior of the protocol model to both
    judges, and the witness must see no inversion and no thread exception."""
    witness = racert.instrument()
    rec = protorec.install()
    try:
        yield rec
    finally:
        protorec.uninstall()
        racert.uninstrument()
    events = rec.snapshot()
    findings = proto.check_refinement(events)
    assert port_proto.check_refinement(events) == findings
    assert not findings, findings
    witness.assert_no_inversions()
    witness.assert_no_thread_exceptions()


@pytest.fixture()
def server():
    srv = SolverServer(tempfile.mktemp(suffix=".sock"), device="cpu")
    srv.start()
    yield srv
    srv.stop()


KERNELS = SchedulerOptions(tpu_min_pods=0)


def _ref_views(zones=("test-zone-a", "test-zone-b")):
    out = []
    for z in zones:
        name = f"existing-{z}"
        labels = {
            ref_wk.TOPOLOGY_ZONE_LABEL_KEY: z,
            ref_wk.HOSTNAME_LABEL_KEY: name,
            ref_wk.INSTANCE_TYPE_LABEL_KEY: "c-2x-amd64-linux",
            ref_wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
            ref_wk.OS_LABEL_KEY: "linux",
            ref_wk.ARCH_LABEL_KEY: "amd64",
            ref_wk.NODEPOOL_LABEL_KEY: "default",
        }
        out.append(
            RefView(
                name=name,
                node_labels=dict(labels),
                labels=labels,
                available={"cpu": 1500, "memory": 3 * 1024**3 * 1000, "pods": 20_000},
                capacity={"cpu": 2000, "memory": 4 * 1024**3 * 1000},
                initialized=True,
            )
        )
    return out


def _ref_problem(n=12, views=True, cluster=False):
    """The reference's objects of one problem: diverse pods, two existing
    nodes, and (with `cluster`) a bound pod on each and namespace labels."""
    from karpenter_tpu.api.objects import Node, ObjectMeta
    from karpenter_tpu.solver.topology import ClusterSource

    ref_fixtures.reset_rng(11)
    its = ref_types(sizes=[2, 8])
    pools = [ref_fixtures.node_pool(name="default")]
    pods = ref_fixtures.make_diverse_pods(n)
    vs = _ref_views() if views else None
    source = None
    if cluster:
        bound = ref_fixtures.make_generic_pods(2)
        for p, v in zip(bound, vs):
            p.node_name = v.name
        source = ClusterSource(
            pods_by_namespace={"default": bound},
            nodes_by_name={v.name: Node(metadata=ObjectMeta(name=v.name, labels=dict(v.labels))) for v in vs},
            namespace_labels={"default": {"env": "test"}},
        )
    return pools, {"default": its}, pods, vs, source


def _port_problem(ref_req: dict):
    """The same problem as the port's objects: the reference's request
    decoded by the port (the same uids, names and values)."""
    pools, ibp, pods, views, daemons, options, force, source = wire._decode_problem_dict(ref_req)
    return pools, ibp, pods, views, source


def _parts(results, pods) -> tuple:
    """A Results as the sidecar tests compare it: each claim's pod names,
    the existing-node placements by pod name, the failed pods."""
    name = {p.uid: p.name for p in pods}
    claims = sorted(tuple(sorted(name[p.uid] for p in c.pods)) for c in results.new_node_claims if c.pods)
    existing = {name[p.uid]: n.name for n in results.existing_nodes for p in n.pods}
    return claims, existing, tuple(sorted(name[u] for u in results.pod_errors))


def _wire_parts(got: dict, pods) -> tuple:
    name = {p.uid: p.name for p in pods}
    claims = sorted(tuple(sorted(name[u] for u in c["pod_uids"])) for c in got["new_node_claims"] if c["pod_uids"])
    existing = {name[u]: n for u, n in got["existing_assignments"].items()}
    return claims, existing, tuple(sorted(name[u] for u in got["pod_errors"]))


# ---------------------------------------------------------------------------
# the wire form


@pytest.mark.parametrize(
    "views,cluster,options",
    [
        (False, False, None),
        (True, False, RefOptions()),
        (True, True, RefOptions(tpu_min_pods=0, timeout_seconds=2.5, ignore_preferences=True, claim_slot_div=3)),
    ],
    ids=["pods", "views", "cluster+options"],
)
def test_request_bytes_equal_reference(views, cluster, options):
    pools, ibp, pods, vs, source = _ref_problem(views=views, cluster=cluster)
    want = ref_service.encode_problem_request(pools, ibp, pods, vs, None, options, False, None, source)
    p_pools, p_ibp, p_pods, p_vs, p_source = _port_problem(json.loads(want))
    p_options = None if options is None else SchedulerOptions(
        ignore_preferences=options.ignore_preferences,
        timeout_seconds=options.timeout_seconds,
        claim_slot_div=options.claim_slot_div,
        tpu_min_pods=options.tpu_min_pods,
    )
    got = wire.encode_problem_request(
        p_pools, p_ibp, p_pods, p_vs, None, p_options, False, None, p_source if cluster else None
    )
    assert got == want


# ---------------------------------------------------------------------------
# decisions over the wire


def test_solve_with_existing_nodes_matches_inprocess_and_reference(server):
    """tests/test_service.py:116: a sidecar solve of a cluster with
    existing capacity sees it; the port's server (on the kernels) decides
    as the port's in-process solve and the reference's do."""
    pools, ibp, pods, vs, _ = _ref_problem()
    req = ref_service.encode_problem_dict(pools, ibp, pods, vs)
    p_pools, p_ibp, p_pods, p_vs, _ = _port_problem(req)
    c = SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT)
    got = c.solve(p_pools, p_ibp, p_pods, state_node_views=p_vs, options=KERNELS)
    c.close()
    assert got["used_tpu"]
    local, sched = solve_in_process(*_port_problem(req)[:4], options=KERNELS, device="cpu")
    assert sched.used_tpu
    from karpenter_tpu.solver import HybridScheduler

    rpools, ribp, rpods, rvs, _ = _ref_problem()
    ref = HybridScheduler(rpools, ribp, RefTopology(rpools, ribp, rpods, state_node_views=rvs), rvs, None,
                          RefOptions(), force_oracle=True).solve(rpods)
    remote = _wire_parts(got, p_pods)
    assert remote == _parts(local, p_pods) == _parts(ref, rpods)
    assert remote[1], "the scenario must use existing capacity"


def _churn_world(churned: bool):
    """tests/test_service.py:395's world, on the port's fixtures: two
    existing nodes; churned, node a loses capacity and node c joins."""
    from karpenter_tpu_torch.api import labels as wk
    from karpenter_tpu_torch.api.objects import Node, ObjectMeta
    from karpenter_tpu_torch.solver.nodes import StateNodeView
    from karpenter_tpu_torch.solver.topology import ClusterSource

    fixtures.reset_rng(11)
    its = construct_instance_types(sizes=[2, 8])
    pools = [fixtures.node_pool(name="default")]
    pods = fixtures.make_diverse_pods(10)

    def view(z):
        name = f"existing-{z}"
        labels = {
            wk.TOPOLOGY_ZONE_LABEL_KEY: z, wk.HOSTNAME_LABEL_KEY: name,
            wk.INSTANCE_TYPE_LABEL_KEY: "c-2x-amd64-linux", wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
            wk.OS_LABEL_KEY: "linux", wk.ARCH_LABEL_KEY: "amd64", wk.NODEPOOL_LABEL_KEY: "default",
        }
        return StateNodeView(
            name=name, node_labels=dict(labels), labels=labels,
            available={"cpu": 1500, "memory": 3 * 1024**3 * 1000, "pods": 20_000},
            capacity={"cpu": 2000, "memory": 4 * 1024**3 * 1000}, initialized=True,
        )

    views = [view("test-zone-a"), view("test-zone-b")]
    if churned:
        views[0].available = {"cpu": 100, "memory": 1024**3 * 1000, "pods": 20_000}
        views.append(view("test-zone-c"))
    nodes = {v.name: Node(metadata=ObjectMeta(name=v.name, labels=dict(v.labels))) for v in views}
    source = ClusterSource(pods_by_namespace={}, nodes_by_name=nodes, namespace_labels={"default": {}})
    return pools, {"default": its}, pods, views, source


def test_delta_solve_with_churn_matches_full_snapshot_and_inprocess(server):
    """tests/test_service.py:395: a SOLVE_DELTA carrying churn decides as a
    full snapshot of the churned world and the in-process solve; a
    same-epoch repeat is served from the server's table cache."""
    c = SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT)
    pools, ibp, pods0, views, source = _churn_world(False)
    first = c.solve(pools, ibp, pods0, state_node_views=views, cluster=source, options=KERNELS)
    assert c.full_solves == 1
    pools, ibp, pods, views, source = _churn_world(False)
    tracing.RING.clear()
    again = c.solve(pools, ibp, pods, state_node_views=views, cluster=source, options=KERNELS)
    assert c.delta_solves == 1 and _wire_parts(again, pods) == _wire_parts(first, pods0)
    server_trace = next(t for t in tracing.RING.snapshot() if t.side == "server")
    assert [s.attrs["outcome"] for s in server_trace.spans if s.name == "table_cache"] == ["hit"]
    assert server_trace.counts.get("upload_bytes", 0) == 0

    pools, ibp, pods, views, source = _churn_world(True)
    got_delta = c.solve(pools, ibp, pods, state_node_views=views, cluster=source, options=KERNELS)
    assert c.delta_solves == 2 and c.resyncs == 0
    c2 = SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT, epochs=False)
    pools, ibp, pods2, views, source = _churn_world(True)
    got_full = c2.solve(pools, ibp, pods2, state_node_views=views, cluster=source, options=KERNELS)
    pools, ibp, pods3, views, source = _churn_world(True)
    local, _ = solve_in_process(pools, ibp, pods3, views, options=KERNELS, cluster=source, device="cpu")
    assert _wire_parts(got_delta, pods) == _wire_parts(got_full, pods2) == _parts(local, pods3)
    assert got_delta["used_tpu"] and got_full["used_tpu"]
    c.close()
    c2.close()


def test_reference_client_is_served(server):
    """tests/test_service.py:191's other judge: the reference's own
    SolverClient (epochs on, then a delta) gets the port's answers."""
    pools, ibp, pods, vs, source = _ref_problem(cluster=True)
    rc = ref_service.SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT)
    assert rc.ping()
    got = rc.solve(pools, ibp, pods, state_node_views=vs, cluster=source, options=RefOptions(tpu_min_pods=0))
    again = rc.solve(pools, ibp, pods, state_node_views=vs, cluster=source, options=RefOptions(tpu_min_pods=0))
    rc.close()
    assert rc.full_solves == 1 and rc.delta_solves == 1
    req = ref_service.encode_problem_dict(pools, ibp, pods, vs, cluster=source)
    p_pools, p_ibp, p_pods, p_vs, p_source = _port_problem(req)
    local, _ = solve_in_process(p_pools, p_ibp, p_pods, p_vs, options=KERNELS, cluster=p_source, device="cpu")
    assert got["used_tpu"]
    assert _wire_parts(got, pods) == _wire_parts(again, pods) == _parts(local, p_pods)


def test_native_client_is_served(server, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ in environment")
    exe = str(tmp_path / "solver_client")
    src = os.path.join(os.path.dirname(__file__), "..", "native", "solver_client.cc")
    subprocess.run([gxx, "-O2", "-std=c++17", "-o", exe, src], check=True, timeout=300)
    assert subprocess.run([exe, server.socket_path, "ping"], capture_output=True, timeout=30).returncode == 0
    pools, ibp, pods, vs, _ = _ref_problem()
    req = ref_service.encode_problem_request(pools, ibp, pods, vs, None, RefOptions(tpu_min_pods=0))
    out = subprocess.run([exe, server.socket_path, "solve"], input=req, capture_output=True, timeout=WIRE_TIMEOUT)
    assert out.returncode == 0, out.stderr
    p_pools, p_ibp, p_pods, p_vs, _ = _port_problem(json.loads(req))
    decoded = wire.decode_result(json.loads(out.stdout), p_pods)
    local, _ = solve_in_process(p_pools, p_ibp, p_pods, p_vs, options=KERNELS, device="cpu")
    assert decoded["used_tpu"]
    assert _wire_parts(decoded, p_pods) == _parts(local, p_pods)


# ---------------------------------------------------------------------------
# the fault envelope (tests/test_service_faults.py)


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        assert got, "peer closed early"
        buf += got
    return buf


def _frame(sock):
    kind, rid, length = struct.unpack("<III", _read_exact(sock, 16)[4:])
    return kind, rid, _read_exact(sock, length)


def _raw(server):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(10)
    sock.connect(server.socket_path)
    return sock


def test_error_frame_keeps_the_connection_serving(server):
    sock = _raw(server)
    bad = b"{not json"
    sock.sendall(MAGIC + struct.pack("<III", KIND_SOLVE, 9, len(bad)) + bad)
    kind, rid, _ = _frame(sock)
    assert (kind, rid) == (KIND_ERROR, 9)
    sock.sendall(MAGIC + struct.pack("<III", KIND_PING, 10, 0))
    kind, rid, body = _frame(sock)
    assert (kind, rid, body) == (KIND_PONG, 10, b"ready")
    sock.close()


def test_oversized_frame_drained_and_connection_kept_usable(server, monkeypatch):
    monkeypatch.setattr(service, "MAX_FRAME_LEN", 1024)
    monkeypatch.setattr(service, "OVERSIZE_DRAIN_MAX", 4 * 1024)
    sock = _raw(server)
    body = b"x" * 2048
    sock.sendall(MAGIC + struct.pack("<III", KIND_SOLVE, 3, len(body)) + body)
    kind, rid, payload = _frame(sock)
    assert (kind, rid) == (KIND_ERROR, 3) and b"exceeds max" in payload
    sock.sendall(MAGIC + struct.pack("<III", KIND_PING, 4, 0))
    assert _frame(sock)[:2] == (KIND_PONG, 4)
    sock.close()


def _small(n=4):
    fixtures.reset_rng(7)
    its = construct_instance_types(sizes=[2, 8])
    return [fixtures.node_pool(name="default")], {"default": its}, fixtures.make_generic_pods(n)


def test_graceful_drain_flushes_inflight_solve(server, monkeypatch):
    original = SolverServer._solve

    def slow(self, payload, req_id=0):
        time.sleep(0.5)
        return original(self, payload, req_id)

    monkeypatch.setattr(SolverServer, "_solve", slow)
    pools, ibp, pods = _small(2)
    c = SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT, epochs=False)
    box = {}
    t = threading.Thread(target=lambda: box.update(got=c.solve(pools, ibp, pods, options=KERNELS)), daemon=True)
    t.start()
    time.sleep(0.2)  # accepted, solving
    server.stop()  # drains, never severs
    t.join(timeout=30)
    assert box["got"]["new_node_claims"] and box["got"]["used_tpu"]
    c.close()


def test_admission_rejection_answers_retry(server):
    """tests/test_service_faults.py:1019's server half: a full gate answers
    RETRY with a backoff hint, and the client raises SolverOverloaded."""
    server.admission.max_inflight = 0
    pools, ibp, pods = _small()
    c = SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT)
    rejected = epochs.ADMISSION_REJECTED.value()
    with pytest.raises(service.SolverOverloaded) as raised:
        c.solve(pools, ibp, pods, options=KERNELS)
    assert raised.value.queue_depth == 0 and raised.value.backoff_hint_seconds > 0
    assert epochs.ADMISSION_REJECTED.value() == rejected + 1
    server.admission.max_inflight = 4
    assert c.solve(pools, ibp, pods, options=KERNELS)["used_tpu"]
    status = c.ping_status()
    assert status["status"] == "ready" and status["epoch_clients"] == 1
    c.close()


def test_device_failure_answers_error_and_is_not_resolved(server, monkeypatch):
    """A failure of the card inside a sidecar solve answers an ERROR frame
    that names it; the server counts it and re-solves nothing on the
    oracle."""

    def out_of_memory(self, pods, trace=None):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(TorchScheduler, "solve", out_of_memory)
    pools, ibp, pods = _small()
    c = SolverClient(server.socket_path, request_timeout=WIRE_TIMEOUT)
    with pytest.raises(SolverError, match="OutOfMemoryError"):
        c.solve(pools, ibp, pods, options=KERNELS)
    assert server.device_failures == 1 and server.solves == 0 and server.oracle_degraded_solves == 0
    c.close()


def test_mid_prewarm_solve_degrades_to_the_oracle():
    """The server's only oracle degrade: a solve while `ready` is unset
    (prewarm running) is served by the oracle, recorded as a fallback."""
    release = threading.Event()
    srv = SolverServer(tempfile.mktemp(suffix=".sock"), prewarm=True, prewarm_fn=lambda stop: release.wait(30),
                       device="cpu")
    srv.start()
    try:
        before = tracing.SOLVE_FALLBACKS.value({"reason": "prewarm_degraded"})
        c = SolverClient(srv.socket_path, request_timeout=WIRE_TIMEOUT)
        assert c.ping_status()["status"] == "prewarming"
        pools, ibp, pods = _small()
        got = c.solve(pools, ibp, pods, options=KERNELS)
        assert not got["used_tpu"] and srv.oracle_degraded_solves == 1
        assert tracing.SOLVE_FALLBACKS.value({"reason": "prewarm_degraded"}) == before + 1
        release.set()
        assert srv.ready.wait(10)
        assert c.solve(pools, ibp, pods, options=KERNELS)["used_tpu"]
        c.close()
    finally:
        release.set()
        srv.stop()


# ---------------------------------------------------------------------------
# fleet lanes through the server (tests/test_fleet.py:107)


def _lane_world(fx, types, cpu: str, n: int = 6):
    fx.reset_rng(5)
    its = types(sizes=[2, 8])
    return [fx.node_pool(name="default")], {"default": its}, fx.make_self_spread_pods(n, cpu)


def _solo(cpu: str) -> tuple:
    pools, ibp, pods = _lane_world(fixtures, construct_instance_types, cpu)
    sched = TorchScheduler(pools, ibp, Topology(pools, ibp, pods), device="cpu")
    res = sched.solve(pods)
    assert not sched.last_used_runs
    return _parts(res, pods)


def _ref_solo(cpu: str) -> tuple:
    pools, ibp, pods = _lane_world(ref_fixtures, ref_types, cpu)
    sched = TpuScheduler(pools, ibp, RefTopology(pools, ibp, pods))
    res = sched.solve(pods)
    assert not sched.last_used_runs
    return _parts(res, pods)


@pytest.mark.parametrize("lanes", [2, 5, 8])
def test_fleet_parity_matrix(lanes):
    profiles = PROFILES[:lanes]
    refs = {cpu: _solo(cpu) for cpu in profiles}
    if lanes == 2:
        assert refs == {cpu: _ref_solo(cpu) for cpu in profiles}
    srv = SolverServer(
        tempfile.mktemp(suffix=".fleet.sock"),
        fleet_window_seconds=WIRE_TIMEOUT,
        fleet_max_lanes=lanes,
        admission=epochs.AdmissionGate(max_inflight=32),
        device="cpu",
    )
    srv.start()
    d0 = fleet.FLEET_DISPATCHES["fleet"]
    c0 = fleet.FLEET_SOLVES["coalesced"]
    seq0 = tracing.Trace("probe").seq
    out, errors = {}, {}
    barrier = threading.Barrier(lanes, timeout=WIRE_TIMEOUT)

    def client(cpu: str) -> None:
        try:
            c = SolverClient(srv.socket_path, request_timeout=WIRE_TIMEOUT)
            pools, ibp, pods = _lane_world(fixtures, construct_instance_types, cpu)
            barrier.wait()
            got = c.solve(pools, ibp, pods)
            out[cpu] = (got, _wire_parts(got, pods))
            c.close()
        except BaseException as e:  # surfaced below
            errors[cpu] = e

    try:
        threads = [threading.Thread(target=client, args=(cpu,), daemon=True) for cpu in profiles]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WIRE_TIMEOUT)
    finally:
        srv.stop()
    assert not errors, errors
    for cpu in profiles:
        got, parts = out[cpu]
        assert got["used_tpu"] and parts == refs[cpu], cpu
    assert fleet.FLEET_SOLVES["coalesced"] - c0 == lanes
    server_traces = [t for t in tracing.RING.snapshot() if t.seq > seq0 and t.side == "server"]
    assert len(server_traces) == lanes
    rounds = set()
    for t in server_traces:
        assert {"fleet_dispatch", "fleet_window"} <= {s.name for s in t.spans}
        win = next(s for s in t.spans if s.name == "fleet_window")
        assert win.attrs["mode"] == "coalesced" and win.attrs["lanes"] == lanes
        assert win.attrs["epoch"].startswith("('c")  # the request rode an epoch
        rounds.add(win.attrs["rounds"])
    # one shared dispatch per round for the whole window
    assert len(rounds) == 1 and fleet.FLEET_DISPATCHES["fleet"] - d0 == rounds.pop()
