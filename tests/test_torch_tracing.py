"""The port's solve tracing (karpenter_tpu_torch/tracing.py) against the
JAX package's.

Twins of tests/test_telemetry.py, with the port on the CPU
(`device="cpu"`, the plain versions): the span, ring, detail-gate and
wire-id mechanics; the oracle-fallback reasons recorded as a marker span
and a labeled counter; one sidecar solve through the port's
`ResilientSolver` and `SolverServer` as one joined trace; the
Provisioner's round trace; the odometer block on each dispatch span and
the kernel metrics. The port's trace of a headline-shaped solve has the
JAX `TpuScheduler`'s top-level phases, bucket event and dispatch blocks.
"""

from __future__ import annotations

import os
import tempfile

import pytest

from karpenter_tpu import jaxsetup
from karpenter_tpu.cloudprovider.kwok import construct_instance_types as ref_types
from karpenter_tpu.solver.topology import Topology as RefTopology
from karpenter_tpu.solver.tpu import TpuScheduler
from karpenter_tpu.testing import fixtures as ref_fixtures
from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.solver.hybrid import ResilientSolver, solve_in_process
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.service import SolverServer
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.testing import fixtures


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


def _problem(n=6, fx=fixtures, types=construct_instance_types, sizes=(2, 8)):
    fx.reset_rng(11)
    its = types(sizes=list(sizes))
    pools = [fx.node_pool(name="default")]
    pods = fx.make_diverse_pods(n)
    return pools, {"default": its}, pods


# ---------------------------------------------------------------------------
# tracing unit behavior (tests/test_telemetry.py:69-126)


def test_trace_spans_phases_and_ring():
    tracing.RING.clear()
    tr = tracing.new_trace("unit")
    with tr.span("encode", pods=3):
        pass
    with tr.span("dispatch"):
        with tr.span("kernel", detail=True):
            pass
    tr.event("oracle_fallback", reason="unsupported")
    tr.count("dispatches")
    tr.annotate(pods=3)
    tr.finish("ok")
    # detail off: the kernel sub-span folds into phases but records no Span
    assert [s.name for s in tr.spans] == ["encode", "dispatch", "oracle_fallback"]
    assert set(tr.phases) == {"encode", "dispatch", "kernel"}
    assert set(tr.top_phases()) == {"encode", "dispatch"}
    assert tr.counts == {"dispatches": 1}
    assert tr.outcome == "ok" and tr.total_seconds >= 0.0
    assert tracing.RING.find(tr.trace_id) == [tr]
    # finish is idempotent: no double ring push
    tr.finish("error")
    assert tr.outcome == "ok"
    assert len(tracing.RING.find(tr.trace_id)) == 1
    d = tr.to_dict()
    assert d["spans"][0]["attrs"] == {"pods": 3}
    assert "kernel" in d["phases"]


def test_detail_gate_records_subspans():
    tracing.set_detail(True)
    try:
        tr = tracing.new_trace("unit")
        with tr.span("dispatch"):
            with tr.span("kernel", detail=True):
                pass
        tr.finish()
        assert [s.name for s in tr.spans] == ["dispatch", "kernel"]
        assert [s.depth for s in tr.spans] == [0, 1]
    finally:
        tracing.set_detail(False)


def test_span_cap_degrades_to_aggregates():
    tr = tracing.new_trace("unit")
    for _ in range(tracing.MAX_SPANS + 10):
        with tr.span("tick"):
            pass
    assert len(tr.spans) == tracing.MAX_SPANS
    assert tr.truncated
    assert tr.phases["tick"] > 0.0
    tr.finish()


def test_wire_id_adoption():
    tr = tracing.new_trace("unit", side="client")
    tr.set_wire_id(42)
    assert tr.trace_id == "w42"
    tr.finish()
    assert tracing.RING.find("w42")[-1] is tr


def test_trace_ring_occupancy_gauge():
    """tests/test_telemetry.py:636: the ring gauge tracks membership and
    pegs at capacity once eviction starts."""
    tracing.RING.clear()
    assert tracing.RING_TRACES.value() == 0.0
    for _ in range(3):
        tracing.new_trace("unit").finish()
    assert tracing.RING_TRACES.value() == 3.0
    for _ in range(tracing.RING_CAPACITY + 10):
        tracing.new_trace("unit").finish()
    assert tracing.RING_TRACES.value() == float(tracing.RING_CAPACITY)
    tracing.RING.clear()
    assert tracing.RING_TRACES.value() == 0.0


def test_unsupported_outcome_stays_out_of_the_ring():
    tracing.RING.clear()
    before = tracing.SOLVE_TRACES.value({"kind": "sweep", "outcome": "unsupported"})
    tracing.new_trace("sweep").finish("unsupported")
    assert tracing.RING.snapshot() == []
    assert tracing.SOLVE_TRACES.value({"kind": "sweep", "outcome": "unsupported"}) == before + 1


# ---------------------------------------------------------------------------
# fallback reasons: span + labeled counter (tests/test_telemetry.py:396, :410)


def test_small_batch_fallback_recorded_as_span_and_counter():
    tracing.RING.clear()
    pools, ibp, pods = _problem(4)
    before = tracing.SOLVE_FALLBACKS.value({"reason": "small_batch"})
    _, sched = solve_in_process(pools, ibp, pods, device="cpu")  # below the crossover
    assert sched.used_tpu is False and sched.fallback_kind == "small_batch"
    assert tracing.SOLVE_FALLBACKS.value({"reason": "small_batch"}) == before + 1
    tr = tracing.RING.snapshot()[-1]
    spans = {s.name: s for s in tr.spans}
    assert spans["oracle_fallback"].attrs["reason"] == "small_batch"
    assert "oracle" in spans and "topology" in spans
    assert tr.attrs.get("used_tpu") is False


def test_forced_oracle_fallback_recorded():
    tracing.RING.clear()
    pools, ibp, pods = _problem(3)
    before = tracing.SOLVE_FALLBACKS.value({"reason": "forced"})
    solve_in_process(pools, ibp, pods, force_oracle=True, device="cpu")
    assert tracing.SOLVE_FALLBACKS.value({"reason": "forced"}) == before + 1
    tr = tracing.RING.snapshot()[-1]
    assert any(s.name == "oracle_fallback" and s.attrs.get("reason") == "forced" for s in tr.spans)


# ---------------------------------------------------------------------------
# the sidecar path (tests/test_telemetry.py:429)


def test_sidecar_solve_yields_one_joined_trace():
    """One solve through the port's ResilientSolver with its sidecar
    active is one logical trace: the client and server halves share the
    wire correlation id and together cover encode/upload/dispatch/decode."""
    tracing.RING.clear()
    path = tempfile.mktemp(suffix=".sock")
    srv = SolverServer(path, device="cpu")
    srv.start()
    try:
        rs = ResilientSolver(socket_path=path, device="cpu")
        pools, ibp, pods = _problem(6)
        results = rs.solve(pools, ibp, pods, options=SchedulerOptions(tpu_min_pods=0))
        assert rs.last_used == "sidecar"
        assert results.new_node_claims
    finally:
        srv.stop()
    wired: dict[str, list] = {}
    for t in tracing.RING.snapshot():
        if t.trace_id.startswith("w"):
            wired.setdefault(t.trace_id, []).append(t)
    pairs = [v for v in wired.values() if len(v) == 2]
    assert len(pairs) == 1, f"expected one joined trace, got {wired}"
    client = next(t for t in pairs[0] if t.side == "local")
    server = next(t for t in pairs[0] if t.side == "server")
    assert client.outcome == "ok" and server.outcome == "ok"
    assert {"sidecar", "wire_encode", "wire_roundtrip", "wire_decode"} <= {s.name for s in client.spans}
    assert {"wire_decode_request", "encode", "upload", "dispatch", "decode", "wire_encode_result"} <= {
        s.name for s in server.spans
    }
    assert server.attrs.get("used_tpu") is True
    assert server.counts.get("dispatches", 0) >= 1
    assert server.counts.get("upload_bytes", 0) > 0
    # the server's table cache saw its first encoding: a miss
    assert [s.attrs["outcome"] for s in server.spans if s.name == "table_cache"] == ["miss"]


def test_dead_sidecar_degrade_keeps_one_trace():
    """Sidecar unreachable: the trace stays one-sided, records the
    sidecar_failed marker, and the in-process floor's phases land on the
    same trace."""
    tracing.RING.clear()
    rs = ResilientSolver(socket_path=tempfile.mktemp(suffix=".sock"), request_timeout_seconds=0.5, device="cpu")
    rs.client.max_retries = 0
    pools, ibp, pods = _problem(4)
    rs.solve(pools, ibp, pods)
    assert rs.last_used in ("tpu", "oracle")
    traces = tracing.RING.snapshot()
    assert len(traces) == 1
    names = [s.name for s in traces[0].spans]
    assert "sidecar_failed" in names
    assert "oracle" in names or "dispatch" in names
    assert traces[0].attrs.get("solver") == rs.last_used


# ---------------------------------------------------------------------------
# the provisioning round trace (tests/test_telemetry.py:538)


def test_provisioner_round_lands_one_trace():
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.controllers.kube import FakeClock, SimKube
    from karpenter_tpu_torch.controllers.provisioning import Provisioner
    from karpenter_tpu_torch.controllers.state import Cluster, wire_informers

    tracing.RING.clear()
    clock = FakeClock()
    kube = SimKube(clock)
    cluster = Cluster(clock)
    wire_informers(kube, cluster)
    cloud = KwokCloudProvider(kube, clock, instance_types=construct_instance_types(sizes=[2, 8]))
    kube.create("NodePool", fixtures.node_pool(name="default"))
    fixtures.reset_rng(5)
    for p in fixtures.make_generic_pods(3):
        kube.create("Pod", p)
    prov = Provisioner(kube, cluster, cloud, clock, force_oracle=True)
    prov.reconcile(ignore_batcher=True)
    rounds = [t for t in tracing.RING.snapshot() if t.kind == "provisioning"]
    assert rounds == [prov.last_trace]
    tr = rounds[-1]
    assert tr.outcome == "ok"
    names = {s.name for s in tr.spans}
    assert "build_inputs" in names and "topology" in names
    assert tr.attrs.get("solver") == "oracle"
    assert tr.attrs.get("pods") == 3


# ---------------------------------------------------------------------------
# kernel odometers on the dispatch spans (tests/test_telemetry.py:713, :738)


def _port_solve(n=24, force_scan=False):
    pools, ibp, pods = _problem(n)
    sched = TorchScheduler(pools, ibp, Topology(pools, ibp, pods), device="cpu")
    sched.debug_force_scan = force_scan
    sched.solve(pods)
    return sched


def test_dispatch_spans_carry_kernel_odometer_block():
    tracing.RING.clear()
    sched = _port_solve()
    tr = sched.last_profile
    dispatch_spans = [s for s in tr.spans if s.name == "dispatch"]
    assert dispatch_spans, [s.name for s in tr.spans]
    blocks = [s.attrs.get("kernel") for s in dispatch_spans]
    assert all(b is not None for b in blocks), blocks
    assert sum(b["steps"] for b in blocks) == sched.last_odometer["steps"]
    assert tr.counts.get("kernel_iterations") == sched.last_odometer["steps"]
    # last_phases reads the trace's clock: each phase is the trace's own
    assert {k: tr.phases[k] for k in sched.last_phases} == sched.last_phases
    assert {"encode", "order", "upload", "dispatch", "decode"} <= set(sched.last_phases)


@pytest.mark.parametrize("force_scan", [False, True], ids=["runs", "scan"])
def test_kernel_metrics_accumulate_on_solve(force_scan):
    path = "scan" if force_scan else "runs"
    iters = tracing.KERNEL_ITERATIONS.value({"path": path})
    claims = tracing.KERNEL_CLAIMS_OPENED.value()
    occ = tracing.KERNEL_CLAIM_OCCUPANCY.count()
    dispatches = tracing.SOLVE_DISPATCHES.value({"path": path})
    sched = _port_solve(force_scan=force_scan)
    assert sched.last_used_runs is not force_scan
    assert tracing.KERNEL_ITERATIONS.value({"path": path}) - iters == sched.last_odometer["steps"] > 0
    assert tracing.KERNEL_CLAIMS_OPENED.value() - claims == sched.last_odometer["claims_opened"]
    assert tracing.KERNEL_CLAIM_OCCUPANCY.count() == occ + 1
    assert tracing.SOLVE_DISPATCHES.value({"path": path}) - dispatches == sched.last_odometer["dispatches"]


def _shape(tr) -> tuple:
    """A solve trace as the two packages must agree on it: the top-level
    phases in waterfall order (repeats folded), the bucket event, each
    dispatch span's path and odometer block, and the counts."""
    top = []
    for s in tr.spans:
        if s.depth == 0 and s.dur > 0 and (not top or top[-1] != s.name):
            top.append(s.name)
    bucket = [dict(s.attrs) for s in tr.spans if s.name == "bucket"]
    blocks = [(s.attrs.get("path"), s.attrs.get("kernel")) for s in tr.spans if s.name == "dispatch"]
    counts = {k: v for k, v in tr.counts.items() if k != "upload_bytes"}
    return top, bucket, blocks, counts


def test_headline_shaped_trace_matches_reference():
    """The diverse mix against KWOK types (the headline's shape, cut to
    160 pods on the 2-core types over 64 claim slots, so the runs path
    regrows once): the same top-level phases, bucket event, dispatch
    blocks and counts as the JAX TpuScheduler's trace of the same solve."""
    n = 160
    opts = dict(claim_slot_div=10_000)
    rpools, ribp, rpods = _problem(n, ref_fixtures, ref_types, sizes=(2,))
    from karpenter_tpu.solver.oracle import SchedulerOptions as RefOptions

    ref = TpuScheduler(rpools, ribp, RefTopology(rpools, ribp, rpods), options=RefOptions(**opts))
    ref.solve(rpods)
    pools, ibp, pods = _problem(n, sizes=(2,))
    port = TorchScheduler(pools, ibp, Topology(pools, ibp, pods), options=SchedulerOptions(**opts), device="cpu")
    port.solve(pods)
    assert port.last_used_runs and ref.last_used_runs
    got, want = _shape(port.last_profile), _shape(ref.last_profile)
    assert got == want
    assert got[0] == ["encode", "order", "upload", "dispatch", "regrow", "dispatch", "decode"]


# ---------------------------------------------------------------------------
# the sweeps' spans and counters (disruption/sweep.py, setsweep.py)


def test_sweep_dispatches_are_traced():
    """A standalone prefix sweep owns a "sweep" trace (union encode and
    upload, one dispatch span with the odometer steps); a set sweep's
    evaluate records its dispatch on the caller's trace and feeds the
    set-lane and dispatch counters."""
    import numpy as np

    from karpenter_tpu_torch.controllers.disruption import setsweep, sweep
    from karpenter_tpu_torch.controllers.disruption.helpers import build_candidates
    from karpenter_tpu_torch.testing.fixtures import underutilized_world

    w = underutilized_world(12, n_pending=2)
    cands = build_candidates(w.kube, w.cluster, w.cloud, w.clock, lambda c: c.consolidatable())
    cands.sort(key=lambda c: (c.disruption_cost, c.name))
    cands = cands[:6]
    tracing.RING.clear()
    iters = tracing.KERNEL_ITERATIONS.value({"path": "sweep"})
    verdicts = sweep.prefix_feasibility(w.kube, w.cluster, w.cloud, cands, device="cpu")
    assert len(verdicts) == len(cands)
    (tr,) = [t for t in tracing.RING.snapshot() if t.kind == "sweep"]
    assert tr.outcome == "ok" and tr.attrs == {"candidates": 6, "singleton": False}
    names = [s.name for s in tr.spans]
    assert names[:2] == ["encode", "upload"] and names.count("dispatch") == 1
    dsp = next(s for s in tr.spans if s.name == "dispatch")
    assert dsp.attrs["path"] == sweep.last_sweep["path"] and dsp.attrs["kernel"]["steps"] == sweep.last_sweep["steps"]
    assert tr.counts["dispatches"] == 1
    assert tracing.KERNEL_ITERATIONS.value({"path": "sweep"}) - iters == sweep.last_sweep["steps"]

    ctx = setsweep.SetSweepContext.build(w.kube, w.cluster, w.cloud, cands, device="cpu")
    member = np.eye(len(cands), dtype=bool)
    lanes = tracing.SWEEP_SET_LANES.value()
    own = tracing.new_trace("setsweep")
    feasible = ctx.evaluate(member, trace=own)
    own.finish()
    assert len(feasible) == len(cands)
    assert own.counts["set_lanes"] == len(cands) == tracing.SWEEP_SET_LANES.value() - lanes
    assert [s.attrs["path"] for s in own.spans if s.name == "dispatch"] == ["setsweep"]
