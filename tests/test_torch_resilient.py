"""The port's resilient sidecar boundary (karpenter_tpu_torch/solver/hybrid.py
`CircuitBreaker`, `ResilientSolver`; the Provisioner's `solver=`) against
the JAX package's.

Twins of tests/test_service_faults.py, with the port's server solving on
the CPU (`device="cpu"`):

- the breaker's state machine, its lost half-open probe and its lock
  under concurrent failures (:540, :561, :582);
- a ResilientSolver solve decides as the in-process solve, with
  launchable claims (:616), and the wire deadline covers the solve budget;
- the provisioning loop falls back in the SAME reconcile when the server
  dies, the breaker opens, and it closes again after the server returns
  (:414); an admission RETRY degrades without a breaker failure (:1019);
- the port's Provisioner with `solver=` and its sidecar decides, creates
  and binds as the reference's Provisioner with `solver=` and its
  sidecar on the same cluster.

Every test records the port's protocol events (`analysis.protorec`) and
hands them to the reference's judge, `proto.check_refinement`.
"""

from __future__ import annotations

import os
import tempfile
import threading

import pytest

from karpenter_tpu import jaxsetup
from karpenter_tpu.analysis import proto
from karpenter_tpu.api.codec import to_jsonable
from karpenter_tpu.controllers import provisioning as rprovisioning
from karpenter_tpu.controllers.provisioning import Provisioner as RProvisioner
from karpenter_tpu.options import Options as ROptions
from karpenter_tpu.solver.hybrid import ResilientSolver as RefResilientSolver
from karpenter_tpu.solver.service import SolverServer as RefSolverServer
from karpenter_tpu_torch.analysis import protorec
from karpenter_tpu_torch.api import codec as pcodec
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.controllers import provisioning as pprovisioning
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.options import Options
from karpenter_tpu_torch.solver.hybrid import (
    SIDECAR_REQUESTS,
    SOLVE_DEADLINE_GRACE_SECONDS,
    SOLVER_FALLBACK,
    CircuitBreaker,
    ResilientSolver,
    solve_in_process,
)
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.service import SolverServer, SolverUnavailable
from karpenter_tpu_torch.testing import fixtures
from test_torch_provisioning import _claim_view, _events, pending_world, port_world

WIRE_TIMEOUT = 120.0
KERNELS = SchedulerOptions(tpu_min_pods=0)


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
    rec = protorec.install()
    yield rec
    protorec.uninstall()
    findings = proto.check_refinement(rec.snapshot())
    assert not findings, findings


@pytest.fixture()
def server():
    srv = SolverServer(tempfile.mktemp(suffix=".sock"), device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _problem(n=8):
    fixtures.reset_rng(7)
    its = construct_instance_types(sizes=[2, 8])
    return [fixtures.node_pool(name="default")], {"default": its}, fixtures.make_generic_pods(n)


def _parts(results) -> tuple:
    claims = sorted(tuple(sorted(p.name for p in c.pods)) for c in results.new_node_claims if c.pods)
    existing = sorted((n.name, tuple(sorted(p.name for p in n.pods))) for n in results.existing_nodes if n.pods)
    return claims, existing, sorted(results.pod_errors)


# ---------------------------------------------------------------------------
# the breaker (tests/test_service_faults.py:540, :561, :582)


def test_circuit_breaker_state_machine(recorder):
    t = {"now": 0.0}
    b = CircuitBreaker(failure_threshold=3, cooldown_seconds=5.0, clock=lambda: t["now"])
    assert b.state == "closed" and b.allow()
    b.record_failure()
    b.record_failure()
    assert b.state == "closed" and b.allow()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    t["now"] = 4.9
    assert not b.allow()
    t["now"] = 5.0
    assert b.allow() and b.state == "half-open"
    b.record_failure()  # the probe failed: open again, a fresh cooldown
    assert b.state == "open" and not b.allow()
    t["now"] = 10.0
    assert b.allow() and b.state == "half-open"
    b.record_success()
    assert b.state == "closed" and b.allow()
    events = [e["ev"] for e in recorder.snapshot()]
    assert events.count("breaker_failure") == 4 and events.count("breaker_success") == 1


def test_circuit_breaker_recovers_from_lost_half_open_probe():
    t = {"now": 0.0}
    b = CircuitBreaker(failure_threshold=1, cooldown_seconds=5.0, clock=lambda: t["now"])
    b.record_failure()
    assert b.state == "open"
    t["now"] = 5.0
    assert b.allow()  # the probe is admitted...
    assert b.state == "half-open" and not b.allow()  # ...and exclusive
    t["now"] = 10.0  # it never reported back: a cooldown later, a new one
    assert b.allow()
    assert b.state == "half-open" and not b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_circuit_breaker_is_thread_safe_under_concurrent_failures():
    threads_n, per_thread = 8, 8
    b = CircuitBreaker(failure_threshold=threads_n * per_thread, cooldown_seconds=5.0, clock=lambda: 0.0)
    barrier = threading.Barrier(threads_n, timeout=30)

    def hammer():
        barrier.wait()
        for _ in range(per_thread):
            b.record_failure()

    workers = [threading.Thread(target=hammer) for _ in range(threads_n)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=30)
    assert b.consecutive_failures == threads_n * per_thread
    assert b.state == "open" and not b.allow()
    b.record_success()
    assert b.state == "closed" and b.consecutive_failures == 0 and b.allow()


# ---------------------------------------------------------------------------
# ResilientSolver


def test_remote_solve_matches_in_process_through_resilient_solver(server):
    """tests/test_service_faults.py:616: the resilience layer changes no
    decision, and the remote claims are launchable."""
    rs = ResilientSolver(server.socket_path, request_timeout_seconds=WIRE_TIMEOUT, device="cpu")
    ok = SIDECAR_REQUESTS.value({"outcome": "success"})
    remote = rs.solve(*_problem(), options=KERNELS)
    assert rs.last_used == "sidecar" and rs.fallback_reason is None
    assert SIDECAR_REQUESTS.value({"outcome": "success"}) == ok + 1
    local, sched = solve_in_process(*_problem(), options=KERNELS, device="cpu")
    assert sched.used_tpu
    assert _parts(remote) == _parts(local)
    for claim in remote.new_node_claims:
        nc = claim.to_node_claim({})
        assert nc.requirements and nc.resources_requests
    assert server.solves == 1


def test_wire_deadline_covers_server_solve_budget():
    class StubClient:
        seen_timeout = None

        def solve(self, *args, timeout=None, **kwargs):
            self.seen_timeout = timeout
            raise SolverUnavailable("stub: not dialing")

    stub = StubClient()
    rs = ResilientSolver(client=stub, request_timeout_seconds=5.0, device="cpu")
    r = rs.solve(*_problem(2), options=SchedulerOptions(timeout_seconds=60.0), force_oracle=True)
    assert stub.seen_timeout >= 60.0 + SOLVE_DEADLINE_GRACE_SECONDS
    assert rs.last_used == "oracle" and not r.pod_errors
    rs.solve(*_problem(2), options=SchedulerOptions(), force_oracle=True)
    assert stub.seen_timeout == 5.0


def test_admission_rejection_degrades_without_breaker_trip(server):
    server.admission.max_inflight = 0
    now = {"t": 1000.0}
    rs = ResilientSolver(server.socket_path, request_timeout_seconds=30.0, clock=lambda: now["t"], device="cpu")
    r = rs.solve(*_problem(4), options=KERNELS)
    assert not r.pod_errors and rs.last_used == "tpu"
    assert "admission rejected" in rs.fallback_reason
    assert rs.breaker.state == "closed" and rs.breaker.consecutive_failures == 0
    dials = rs.client.reconnects
    rs.solve(*_problem(4), options=KERNELS)  # inside the backoff: not dialed
    assert rs.last_used == "tpu" and rs.client.reconnects == dials
    server.admission.max_inflight = 4
    now["t"] += 3600.0
    rs.solve(*_problem(4), options=KERNELS)
    assert rs.last_used == "sidecar"


# ---------------------------------------------------------------------------
# the provisioning loop across a dying sidecar (tests/test_service_faults.py:414)


def _port_cluster(failure_threshold: int, server_path: str):
    """A port SimKube with one pool, and a Provisioner whose ResilientSolver
    (on the cluster's FakeClock) dials `server_path`."""
    from karpenter_tpu_torch.api.objects import Budget
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.controllers.kube import FakeClock, SimKube
    from karpenter_tpu_torch.controllers.state import Cluster, wire_informers

    clock = FakeClock()
    kube = SimKube(clock)
    cluster = Cluster(clock)
    wire_informers(kube, cluster)
    cloud = KwokCloudProvider(kube, clock, instance_types=construct_instance_types(sizes=[2, 8]))
    fixtures.reset_rng(5)
    kube.create("NodePool", fixtures.node_pool(name="default", budgets=[Budget(nodes="100%")]))
    rs = ResilientSolver(server_path, failure_threshold=failure_threshold, cooldown_seconds=30.0,
                         request_timeout_seconds=2.0, clock=clock.now, device="cpu")
    rs.client.backoff_base = 0.01
    prov = Provisioner(kube, cluster, cloud, clock, Options(tpu_min_pods=0), device="cpu", solver=rs)
    return prov, rs, clock


def _round(prov, tag: str, n: int):
    from karpenter_tpu_torch.controllers.state import is_provisionable

    for i in range(n):
        prov.kube.create("Pod", fixtures.pod(name=f"{tag}-{i}", requests={"cpu": "400m"}))
    pending = sum(1 for p in prov.kube.list("Pod") if is_provisionable(p))
    res = prov.reconcile(ignore_batcher=True).results
    placed = sum(len(c.pods) for c in res.new_node_claims) + sum(len(n.pods) for n in res.existing_nodes)
    assert not res.pod_errors and placed == pending
    return prov.last_solver_used


def test_sidecar_killed_falls_back_same_reconcile(server):
    prov, rs, clock = _port_cluster(2, server.socket_path)
    assert _round(prov, "a", 4) == "sidecar" and server.solves == 1
    assert prov.last_trace.attrs["solver"] == "sidecar"
    server.stop()
    unavailable = SOLVER_FALLBACK.value({"reason": "sidecar_unavailable"})
    assert _round(prov, "b", 4) == "tpu"  # the same reconcile, in-process on the kernels
    assert SOLVER_FALLBACK.value({"reason": "sidecar_unavailable"}) == unavailable + 1
    assert rs.breaker.state == "closed"  # one failure of a threshold of 2
    assert any(s.name == "sidecar_failed" for s in prov.last_trace.spans)
    assert _round(prov, "c", 2) == "tpu"
    assert rs.breaker.state == "open"
    dials = rs.client.reconnects
    circuit = SOLVER_FALLBACK.value({"reason": "circuit_open"})
    assert _round(prov, "d", 2) == "tpu"
    assert rs.client.reconnects == dials, "an open breaker must not dial the sidecar"
    assert SOLVER_FALLBACK.value({"reason": "circuit_open"}) == circuit + 1
    server.start()
    clock.advance(31.0)
    assert _round(prov, "e", 2) == "sidecar"
    assert rs.breaker.state == "closed"


# ---------------------------------------------------------------------------
# the Provisioner with solver= against the reference's


def test_provisioner_with_solver_matches_reference():
    kube, cluster, cloud, clock = pending_world()
    w = port_world(kube, cluster, cloud, clock)
    rsrv = RefSolverServer(tempfile.mktemp(suffix=".ref.sock"))
    psrv = SolverServer(tempfile.mktemp(suffix=".sock"), device="cpu")
    rsrv.start()
    psrv.start()
    try:
        rp = RProvisioner(kube, cluster, cloud, clock, ROptions(tpu_min_pods=0),
                          solver=RefResilientSolver(rsrv.socket_path, request_timeout_seconds=WIRE_TIMEOUT))
        pp = Provisioner(w.kube, w.cluster, w.cloud, w.clock, Options(tpu_min_pods=0), device="cpu",
                         solver=ResilientSolver(psrv.socket_path, request_timeout_seconds=WIRE_TIMEOUT, device="cpu"))
        pprovisioning._claim_name_seq[0] = rprovisioning._claim_name_seq[0]
        want, got = rp.reconcile(ignore_batcher=True), pp.reconcile(ignore_batcher=True)
    finally:
        rsrv.stop()
        psrv.stop()

    def outcome(prov, result, dump):
        return {
            "parts": _parts(result.results),
            "claims": sorted(_claim_view(dump(c)) for c in result.created_claims),
            "bound": dict(result.bound_pods),
            "solver": prov.last_solver_used,
            "events": _events(prov.recorder),
        }

    assert outcome(pp, got, pcodec.to_jsonable) == outcome(rp, want, to_jsonable)
    assert pp.last_solver_used == "sidecar" and pp.last_scheduler is None
    assert psrv.solves == 1 and got.created_claims
    assert pp.last_trace.kind == "provisioning" and any(s.name == "sidecar" for s in pp.last_trace.spans)
