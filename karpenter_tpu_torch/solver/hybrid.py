"""TorchHybridScheduler: the solver dispatch — the card first, the oracle
for what the tensor encoding does not cover.

A port of the reference's `solver/hybrid.py` (`HybridScheduler`, `solve`,
`_pristine_oracle_solve`, `solve_in_process`). It is the entry point the
provisioner and the disruption simulation call:

- a topology-free batch below `SchedulerOptions.tpu_min_pods` (the card's
  crossover, solver/oracle.py) runs on the oracle;
- otherwise pods the encoding supports (`tpu_problem.pod_unsupported_reason`
  is None) ride `TorchScheduler` on the device, and the rest continue on the
  oracle against the state the kernels leave behind (the decode writes the
  claims, existing-node usage, pool limits and topology counts back onto
  the shared oracle);
- `UnsupportedBySolver` from encode (raised before any state is mutated)
  falls back to the same oracle;
- any other error during the kernel solve is the last-resort guard: it is
  logged at error level, counted as `tpu_error`, and the whole batch is
  re-solved on a pristine oracle (fresh Topology, fresh Scheduler);
- except a failure of the card itself (`device_failure`: a kernel that did
  not build, load or launch, a CUDA error or out-of-memory from torch),
  which propagates: degrading it to the oracle would hide the card.

The device is chosen when the scheduler is built: `TorchScheduler`'s
constructor resolves `device` (None = the card) outside the guard, so a
machine without CUDA raises there instead of degrading to the oracle.

After `solve()`: `used_tpu`, `fallback_reason` (the reference's message
strings), `fallback_kind` (the reason class: forced, small_batch,
unsupported, tpu_error, partition_continuation; None when every pod rode
the kernel) and `last_phases` (host seconds of the kernel solve and the
oracle part). Each routing decision is recorded on the solve's trace
(`tracing.record_fallback`: a marker span and `tracing.SOLVE_FALLBACKS`,
which this module re-exports as `SOLVE_FALLBACKS`).

The top of the failure ladder, as in the reference:

    sidecar solve -> [breaker] -> in-process card solve -> [guard] -> oracle

- `ResilientSolver` wraps the sidecar boundary (solver/service.py) with a
  `CircuitBreaker`: after `failure_threshold` consecutive sidecar failures
  the breaker opens and solves run in-process (`solve_in_process` on
  `device`) for `cooldown_seconds`, then a half-open probe decides
  whether to close again. An admission RETRY (`SolverOverloaded`) is
  backpressure, not a fault: the caller solves in-process and honors the
  backoff hint, and the breaker records a success. Breaker transitions
  and attempts are recorded through `analysis.protorec` when a recorder
  is installed.
- A sidecar answer comes back as `RemoteNodeClaim`/`RemoteExistingNode`
  results the provisioning controller consumes like local ones.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from karpenter_tpu_torch import _build
from karpenter_tpu_torch import logging as klog
from karpenter_tpu_torch import metrics, tracing
from karpenter_tpu_torch.analysis import protorec
from karpenter_tpu_torch.api.objects import NodePool, Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
from karpenter_tpu_torch.solver.epochs import SolverOverloaded
from karpenter_tpu_torch.solver.nodes import StateNodeView
from karpenter_tpu_torch.solver.oracle import Results, Scheduler, SchedulerOptions
from karpenter_tpu_torch.solver.topology import ClusterSource, Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.solver.tpu_problem import UnsupportedBySolver, pod_unsupported_reason

# the per-reason oracle counter lives with the traces (record_fallback
# bumps it); the alias keeps this module's name for it
SOLVE_FALLBACKS = tracing.SOLVE_FALLBACKS

# -- resilience metrics -------------------------------------------------------

SOLVER_FALLBACK = metrics.REGISTRY.counter(
    "karpenter_solver_fallback_total",
    "Solves that degraded down the failure ladder, by reason.",
    ("reason",),
)
SIDECAR_REQUESTS = metrics.REGISTRY.counter(
    "karpenter_solver_sidecar_requests_total",
    "Sidecar solve attempts, by outcome.",
    ("outcome",),
)
BREAKER_STATE = metrics.REGISTRY.gauge(
    "karpenter_solver_breaker_state",
    "Sidecar circuit-breaker state (0 closed, 1 half-open, 2 open).",
    ("breaker",),
)

_BREAKER_STATE_CODES = {"closed": 0.0, "half-open": 1.0, "open": 2.0}

# Slack added on top of the server-side solve budget when deriving the
# client's wire deadline: covers serialization + transfer + scheduling
# jitter so a solve using its FULL budget still answers in time.
SOLVE_DEADLINE_GRACE_SECONDS = 15.0

_log = klog.root.named("solver")

# torch's errors of the device: out of memory, and (torch 2.8 on) a CUDA
# runtime error; older torch raises the latter as RuntimeError "CUDA error: ..."
_TORCH_DEVICE_ERRORS = (torch.OutOfMemoryError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()
)


def device_failure(e: BaseException) -> bool:
    """True where the card failed, not the host code around it: a kernel
    that did not build, load or launch, or a CUDA error or out-of-memory
    raised by torch. The last-resort guard lets these through."""
    return isinstance(e, (_build.DeviceError, *_TORCH_DEVICE_ERRORS)) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e)
    )


class TorchHybridScheduler:
    """Same constructor and solve() surface as oracle.Scheduler, plus
    `force_oracle`, `table_cache` (an epochs.DeviceTableCache), `fleet` (a
    fleet.FleetCoalescer), `epoch_key` (the request's (client, epoch id))
    for TorchScheduler, and `device` (None = the card; "cpu" for the plain
    versions)."""

    def __init__(
        self,
        node_pools: list[NodePool],
        instance_types_by_pool: dict[str, InstanceTypes],
        topology: Topology,
        state_nodes: Optional[list[StateNodeView]] = None,
        daemonset_pods: Optional[list[Pod]] = None,
        options: Optional[SchedulerOptions] = None,
        force_oracle: bool = False,
        table_cache=None,
        fleet=None,
        epoch_key=None,
        device=None,
    ):
        self.force_oracle = force_oracle
        self.used_tpu: Optional[bool] = None
        self.fallback_reason: Optional[str] = None
        self.fallback_kind: Optional[str] = None
        self.last_phases: dict[str, float] = {}
        # kept for the last-resort guard: a pristine oracle re-solve needs
        # the raw inputs, not the possibly half-mutated shared state
        self._node_pools = node_pools
        self._its_by_pool = instance_types_by_pool
        self._state_nodes = state_nodes
        self._daemonset_pods = daemonset_pods
        self._topology = topology
        if force_oracle:
            self.tpu: Optional[TorchScheduler] = None
            self.oracle = Scheduler(
                node_pools, instance_types_by_pool, topology, state_nodes, daemonset_pods, options
            )
        else:
            self.tpu = TorchScheduler(
                node_pools,
                instance_types_by_pool,
                topology,
                state_nodes,
                daemonset_pods,
                options,
                device=device,
                fleet=fleet,
                table_cache=table_cache,
                epoch_key=epoch_key,
            )
            self.oracle = self.tpu.oracle
        self.opts = self.oracle.opts

    def _fall_back(self, tr, kind: str, reason: Optional[str]) -> None:
        self.used_tpu = False
        self.fallback_reason = reason
        self.fallback_kind = kind
        tracing.record_fallback(tr, kind, reason or "")

    def _timed(self, phase: str, solve, pods: list[Pod]) -> Results:
        t0 = time.monotonic()
        try:
            return solve(pods)
        finally:
            self.last_phases[phase] = time.monotonic() - t0

    def _oracle_solve(self, tr, pods: list[Pod]) -> Results:
        with tr.span("oracle", pods=len(pods)):
            return self._timed("oracle", self.oracle.solve, pods)

    def solve(self, pods: list[Pod], trace=None) -> Results:
        """Never raises UnsupportedBySolver (hybrid.py:150 `solve`).

        `trace` (tracing.Trace, optional) records the routing decision and
        the oracle-fallback reasons, and is threaded down into the solve
        driver's host phases. A standalone call owns its own trace."""
        with tracing.maybe_trace(trace, "solve") as tr:
            results = self._solve_traced(pods, tr)
            tr.annotate(used_tpu=self.used_tpu)
            return results

    def _solve_traced(self, pods: list[Pod], tr) -> Results:
        self.fallback_reason = None
        self.fallback_kind = None
        self.last_phases = {}
        if self.tpu is None:
            self.used_tpu = False
            self.fallback_kind = "forced"
            # a degrade decision made ABOVE this scheduler (the sidecar's
            # mid-prewarm force_oracle) already recorded its reason on this
            # trace; recording "forced" again would count the solve twice
            if not any(s.name == "oracle_fallback" for s in tr.spans):
                tracing.record_fallback(tr, "forced", "force_oracle scheduler")
            return self._oracle_solve(tr, pods)

        # below the card's crossover a topology-free batch solves faster on
        # the oracle; topology-bearing problems always ride the kernel
        topo = self.oracle.topology
        if (
            self.opts.tpu_min_pods
            and len(pods) < self.opts.tpu_min_pods
            and not topo.topology_groups
            and not topo.inverse_topology_groups
        ):
            self._fall_back(
                tr,
                "small_batch",
                f"small topology-free batch ({len(pods)} pods < crossover "
                f"{self.opts.tpu_min_pods}) routed to oracle",
            )
            return self._oracle_solve(tr, pods)

        ignore = self.opts.ignore_preferences
        reasons = [pod_unsupported_reason(p, ignore) for p in pods]
        supported = [p for p, r in zip(pods, reasons) if r is None]
        unsupported = [p for p, r in zip(pods, reasons) if r is not None]
        first_reason = next((r for r in reasons if r is not None), None)
        if unsupported and not supported:
            self._fall_back(tr, "unsupported", first_reason)
            return self._oracle_solve(tr, pods)
        try:
            results = self._timed("kernel", lambda ps: self.tpu.solve(ps, trace=tr), supported)
        except UnsupportedBySolver as e:
            # encode_problem raises before mutating the oracle or the
            # shared Topology, so the oracle can run on the same state
            self._fall_back(tr, "unsupported", str(e))
            return self._oracle_solve(tr, pods)
        except Exception as e:
            if device_failure(e):
                raise
            # the last-resort guard: an arbitrary failure may have left the
            # shared oracle/topology half-written, so degrade onto PRISTINE
            # state
            SOLVER_FALLBACK.inc({"reason": "tpu_error"})
            self._fall_back(
                tr,
                "tpu_error",
                f"unexpected TPU-path error, degraded to oracle: {type(e).__name__}: {e}",
            )
            _log.error(
                "TPU path raised unexpectedly; re-solving on a pristine oracle",
                error=f"{type(e).__name__}: {e}",
                pods=len(pods),
            )
            with tr.span("oracle", pods=len(pods)):
                return self._timed("oracle", self._pristine_oracle_solve, pods)
        self.used_tpu = True
        if not unsupported:
            return results
        # continuation: the oracle packs the leftovers into the decoded
        # claims/existing nodes (state and topology already synced)
        self.fallback_reason = f"{len(unsupported)} pod(s) continued on the oracle: {first_reason}"
        self.fallback_kind = "partition_continuation"
        tracing.record_fallback(tr, "partition_continuation", self.fallback_reason)
        cont = self._oracle_solve(tr, unsupported)
        cont.pod_errors.update(results.pod_errors)
        cont.timed_out = cont.timed_out or results.timed_out
        return cont

    def _pristine_oracle_solve(self, pods: list[Pod]) -> Results:
        """Rebuild Topology + Scheduler from the stored constructor inputs
        and solve the FULL pod set (hybrid.py:274). StateNodeViews are
        read-only to the solve, so the fresh scheduler shares them."""
        topology = Topology(
            self._node_pools,
            self._its_by_pool,
            pods,
            cluster=self._topology.cluster,
            state_node_views=self._state_nodes,
            ignore_preferences=self.opts.ignore_preferences,
        )
        self.oracle = Scheduler(
            self._node_pools,
            self._its_by_pool,
            topology,
            self._state_nodes,
            self._daemonset_pods,
            self.opts,
        )
        return self.oracle.solve(pods)


def solve_in_process(
    node_pools: list[NodePool],
    instance_types_by_pool: dict[str, InstanceTypes],
    pods: list[Pod],
    state_node_views: Optional[list[StateNodeView]] = None,
    daemonset_pods: Optional[list[Pod]] = None,
    options: Optional[SchedulerOptions] = None,
    cluster: Optional[ClusterSource] = None,
    force_oracle: bool = False,
    trace=None,
    table_cache=None,
    fleet=None,
    epoch_key=None,
    device=None,
) -> tuple[Results, TorchHybridScheduler]:
    """The in-process solve assembly (hybrid.py:300): Topology +
    TorchHybridScheduler with the options threaded consistently. Every
    path that solves locally — the provisioning controller, the sidecar
    server, ResilientSolver's floor — goes through here. `trace` joins the
    caller's solve trace (a standalone call owns a local one);
    `table_cache` (the sidecar server passes its own) lets repeat solves
    of an unchanged table encoding skip the table uploads; `fleet` lets
    concurrent scan-path solves share one lane launch a round;
    `epoch_key` names the request's epoch on the fleet window's event.
    The scheduler's `last_phases` gains the Topology build's host
    seconds."""
    with tracing.maybe_trace(trace, "solve") as tr:
        t0 = time.monotonic()
        with tr.span("topology", pods=len(pods)):
            topology = Topology(
                node_pools,
                instance_types_by_pool,
                pods,
                cluster=cluster or ClusterSource(),
                state_node_views=state_node_views,
                ignore_preferences=bool(options and options.ignore_preferences),
            )
        dt = time.monotonic() - t0
        scheduler = TorchHybridScheduler(
            node_pools,
            instance_types_by_pool,
            topology,
            state_node_views,
            daemonset_pods,
            options,
            force_oracle=force_oracle,
            table_cache=table_cache,
            fleet=fleet,
            epoch_key=epoch_key,
            device=device,
        )
        results = scheduler.solve(pods, trace=tr)
        scheduler.last_phases["topology"] = dt
        return results, scheduler


# ---------------------------------------------------------------------------
# the resilient service boundary


class CircuitBreaker:
    """Consecutive-failure circuit breaker for the sidecar boundary.

    closed -> (failure_threshold consecutive failures) -> open
    open   -> (cooldown_seconds elapse)                -> half-open
    half-open: one probe rides the sidecar; success -> closed,
               failure -> open again (fresh cooldown).

    `clock` is a zero-arg seconds source (time.monotonic by default;
    tests pass FakeClock.now so cooldowns ride simulated time). `name`
    labels this instance's gauge series — two live breakers (a drained
    control plane overlapping its successor) must not overwrite each
    other's exported state.

    Thread safety: the breaker is driven from every concurrent request
    path (SolverServer handler threads, worker-pool reconciles all
    funnel through ResilientSolver.solve), so the trip/reclose state
    machine and the failure counter mutate under one small lock —
    without it, `consecutive_failures += 1` is a lost-update race, and
    the open->half-open transition in allow() could not be made a
    single-winner decision (the lock is what lets exactly ONE racing
    caller claim the half-open probe; everyone else keeps cooling down
    in-process)."""

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_seconds: float = 30.0,
        clock=None,
        name: str = "sidecar",
    ):
        self.failure_threshold = failure_threshold
        self.cooldown_seconds = cooldown_seconds
        self._clock = clock or time.monotonic
        self.name = name
        self._lock = threading.Lock()
        self.state = "closed"
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_at: Optional[float] = None
        # nothing races __init__, but *_locked means caller-holds — the
        # convention stays checkable only if every call site honors it
        with self._lock:
            self._publish_locked()

    def _publish_locked(self) -> None:
        BREAKER_STATE.set(
            _BREAKER_STATE_CODES[self.state], {"breaker": self.name}
        )

    def _record_locked(self, ev: str, **fields) -> None:
        """Protocol-tier conformance event, emitted under the breaker
        lock so the recorded transition order IS the real one (the
        refinement acceptor in analysis/proto.py checks each event's
        pre/post state legality; analysis/protorec.py docstring covers
        the free-when-off contract)."""
        if protorec.RECORDER is not None:
            protorec.RECORDER.record(
                ev=ev,
                state=self.state,
                failures=self.consecutive_failures,
                threshold=self.failure_threshold,
                **fields,
            )

    def allow(self) -> bool:
        """May the next solve attempt the sidecar? Half-open admits ONE
        probe: the open->half-open transition returns True exactly once
        under the lock; callers racing in behind it see half-open and go
        straight in-process until the probe's record_success/
        record_failure resolves the state. A probe that never reports
        back (its thread killed by BaseException between allow() and
        record_*) must not wedge the breaker refusing the sidecar
        forever: after a full cooldown with no verdict, half-open
        re-admits a fresh probe."""
        now = self._clock()
        with self._lock:
            if self.state == "closed":
                self._record_locked("breaker_allow", granted=True, probe=False)
                return True
            if self.state == "half-open":
                if now - self._probe_at >= self.cooldown_seconds:
                    self._probe_at = now  # lost probe; this caller takes over
                    self._record_locked(
                        "breaker_allow", granted=True, probe=True, takeover=True
                    )
                    return True
                self._record_locked("breaker_allow", granted=False, probe=False)
                return False  # a probe is already in flight
            if now - self._opened_at >= self.cooldown_seconds:
                self.state = "half-open"
                self._probe_at = now
                self._publish_locked()
                self._record_locked(
                    "breaker_allow", granted=True, probe=True, takeover=False
                )
                return True
            self._record_locked("breaker_allow", granted=False, probe=False)
            return False

    def record_success(self) -> None:
        with self._lock:
            prev = self.state
            self.state = "closed"
            self.consecutive_failures = 0
            self._opened_at = None
            self._publish_locked()
            self._record_locked("breaker_success", prev=prev)

    def record_failure(self) -> None:
        with self._lock:
            prev = self.state
            self.consecutive_failures += 1
            if (
                self.state == "half-open"
                or self.consecutive_failures >= self.failure_threshold
            ):
                self.state = "open"
                self._opened_at = self._clock()
            self._publish_locked()
            self._record_locked("breaker_failure", prev=prev)


class RemoteNodeClaim:
    """A new-node decision reconstructed from the wire (service.py RESULT
    frame). Duck-types the slice of SchedulingNodeClaim the provisioning
    controller consumes: .pods, .nodepool_name, .requests, .to_node_claim().
    The launchable NodeClaim itself crossed the wire fully formed — no
    template state is re-derived client-side."""

    def __init__(self, nodepool_name: str, node_claim, requests, pods: list[Pod]):
        self.nodepool_name = nodepool_name
        self._node_claim = node_claim
        self.requests = dict(requests)
        self.pods = pods

    def to_node_claim(self, prices: Optional[dict] = None):
        """The claim as it crossed the wire (`prices`, the launch-price
        memo a local claim takes, has nothing to order here)."""
        return copy.deepcopy(self._node_claim)


@dataclass
class RemoteExistingNode:
    """An existing-capacity placement reconstructed from the wire; only
    .name and .pods are consumed control-plane side (_bind_to_existing)."""

    name: str
    pods: list[Pod] = field(default_factory=list)


class ResilientSolver:
    """The fault-tolerant entry point the provisioning controller calls
    when a sidecar is configured: try the remote solver under the circuit
    breaker, degrade to the in-process TorchHybridScheduler on `device`
    (which itself routes to the oracle what the kernels do not cover) on
    ANY sidecar-side failure — a killed sidecar can never stall a
    reconcile. A failure of the card in that floor propagates, as it does
    from `solve_in_process` (`device_failure`).

    After solve():
    - ``last_used``       'sidecar' | 'tpu' | 'oracle'
    - ``fallback_reason`` why the sidecar was skipped/failed (None when the
                          sidecar answered)
    """

    def __init__(
        self,
        socket_path: Optional[str] = None,
        client=None,
        failure_threshold: int = 3,
        cooldown_seconds: float = 30.0,
        request_timeout_seconds: float = 30.0,
        clock=None,
        breaker: Optional[CircuitBreaker] = None,
        device=None,
    ):
        if client is None:
            # lazy import: service.py imports solve_in_process from here
            from karpenter_tpu_torch.solver.service import SolverClient

            client = SolverClient(socket_path, request_timeout=request_timeout_seconds)
        self.client = client
        self.request_timeout_seconds = request_timeout_seconds
        self._clock = clock or time.monotonic
        self.breaker = breaker or CircuitBreaker(
            failure_threshold, cooldown_seconds, clock=clock
        )
        # admission backpressure (service RETRY frames): the sidecar is
        # healthy but shedding, so the hint gates re-dialing WITHOUT
        # feeding the breaker — an overloaded server must not be scored
        # like a dead one
        self._admission_retry_at = 0.0
        # the in-process floor's device (None = the card)
        self.device = device
        self.last_used: Optional[str] = None
        self.fallback_reason: Optional[str] = None
        self.log = klog.root.named("solver.resilient")

    def solve(
        self,
        node_pools: list[NodePool],
        instance_types_by_pool: dict[str, InstanceTypes],
        pods: list[Pod],
        state_node_views: Optional[list[StateNodeView]] = None,
        daemonset_pods: Optional[list[Pod]] = None,
        options: Optional[SchedulerOptions] = None,
        cluster: Optional[ClusterSource] = None,
        namespace_labels: Optional[dict] = None,
        force_oracle: bool = False,
        trace=None,
    ) -> Results:
        """Never raises for solver-side faults; the in-process ladder is
        always available as the floor. `trace` (tracing.Trace) is the
        provisioning round's trace; sidecar attempts record their span on
        it and the wire client stamps its correlation id as the trace id,
        joining the client- and server-side spans into one trace."""
        with tracing.maybe_trace(trace, "resilient_solve") as tr:
            return self._solve_traced(
                node_pools, instance_types_by_pool, pods, state_node_views,
                daemonset_pods, options, cluster, namespace_labels,
                force_oracle, tr,
            )

    def _record_attempt(self, outcome: str) -> None:
        """Protocol-tier conformance event: one per solve attempt, AFTER
        the breaker verdict that resolves it — the refinement acceptor
        requires e.g. an `overloaded` outcome to carry a breaker_success
        on the same thread (the RETRY-records-success rule this module's
        admission-rejection branch pins)."""
        if protorec.RECORDER is not None:
            protorec.RECORDER.record(
                ev="attempt", outcome=outcome, breaker=self.breaker.state
            )

    def _solve_traced(
        self,
        node_pools,
        instance_types_by_pool,
        pods,
        state_node_views,
        daemonset_pods,
        options,
        cluster,
        namespace_labels,
        force_oracle,
        tr,
    ) -> Results:
        if namespace_labels is None and cluster is not None:
            namespace_labels = cluster.namespace_labels
        # The wire deadline must COVER the server-side solve budget: a solve
        # legitimately using its full timeout_seconds (which would at worst
        # return partial results with timed_out=True) must not be cut off
        # client-side, poisoning the connection and feeding the breaker.
        # request_timeout_seconds is the floor, for transport-level stalls.
        wire_timeout = self.request_timeout_seconds
        if options is not None and options.timeout_seconds:
            wire_timeout = max(
                wire_timeout, options.timeout_seconds + SOLVE_DEADLINE_GRACE_SECONDS
            )
        # backoff is checked BEFORE breaker.allow(): allow() claims the
        # half-open probe slot as a side effect, and a caller that then
        # skips the sidecar for admission backoff would strand the probe
        # until the lost-probe cooldown recovers it
        in_backoff = self._clock() < self._admission_retry_at
        if not in_backoff and self.breaker.allow():
            try:
                with tr.span("sidecar", pods=len(pods)):
                    decoded = self.client.solve(
                        node_pools,
                        instance_types_by_pool,
                        pods,
                        state_node_views,
                        daemonset_pods,
                        options,
                        force_oracle,
                        namespace_labels,
                        timeout=wire_timeout,
                        # the FULL cluster slice (scheduled pods, node
                        # labels) crosses the wire: the sidecar must count
                        # existing anti-affinity/spread state exactly like
                        # in-process
                        cluster=cluster,
                        trace=tr,
                    )
                self.breaker.record_success()
                self._record_attempt("success")
                SIDECAR_REQUESTS.inc({"outcome": "success"})
                self.last_used = "sidecar"
                self.fallback_reason = None
                tr.annotate(solver="sidecar")
                return self._to_results(decoded, pods)
            except SolverOverloaded as e:
                # backpressure, NOT a fault: the server answered a RETRY
                # frame because its solve budget is oversubscribed. The
                # transport round-tripped, so this VERDICT must reach the
                # breaker as a success — a half-open probe that lands on
                # RETRY would otherwise be stranded (neither record_*
                # called), wedging every caller in-process for an extra
                # cooldown per lost-probe recovery. Pacing is the
                # admission backoff's job, not the breaker's.
                self.breaker.record_success()
                self._record_attempt("overloaded")
                self._admission_retry_at = self._clock() + max(
                    0.0, e.backoff_hint_seconds
                )
                SIDECAR_REQUESTS.inc({"outcome": "rejected"})
                SOLVER_FALLBACK.inc({"reason": "admission_rejected"})
                self.fallback_reason = (
                    f"sidecar admission rejected (queue depth "
                    f"{e.queue_depth}); solving in-process, next dial in "
                    f"{e.backoff_hint_seconds:.3f}s"
                )
                tr.event(
                    "admission_rejected",
                    queue_depth=e.queue_depth,
                    backoff_seconds=e.backoff_hint_seconds,
                )
                self.log.warn(
                    "sidecar admission rejected; solving in-process",
                    queue_depth=e.queue_depth,
                    backoff_seconds=e.backoff_hint_seconds,
                )
            except Exception as e:
                self.breaker.record_failure()
                self._record_attempt("failure")
                SIDECAR_REQUESTS.inc({"outcome": "failure"})
                SOLVER_FALLBACK.inc({"reason": "sidecar_unavailable"})
                self.fallback_reason = (
                    f"sidecar solve failed ({type(e).__name__}: {e}); "
                    "degrading to in-process solver"
                )
                tr.event(
                    "sidecar_failed",
                    error=f"{type(e).__name__}: {e}",
                    breaker=self.breaker.state,
                )
                self.log.warn(
                    "sidecar solve failed; degrading to in-process solver",
                    error=f"{type(e).__name__}: {e}",
                    consecutive_failures=self.breaker.consecutive_failures,
                    breaker=self.breaker.state,
                )
        elif in_backoff:
            self._record_attempt("backoff")
            SOLVER_FALLBACK.inc({"reason": "admission_rejected"})
            self.fallback_reason = (
                "sidecar admission backoff in effect; solving in-process"
            )
            tr.event("admission_backoff")
        else:
            self._record_attempt("breaker_denied")
            SOLVER_FALLBACK.inc({"reason": "circuit_open"})
            self.fallback_reason = (
                "sidecar circuit open; solving in-process during cooldown"
            )
            tr.event("circuit_open", breaker=self.breaker.state)
        results = self._solve_in_process(
            node_pools,
            instance_types_by_pool,
            pods,
            state_node_views,
            daemonset_pods,
            options,
            cluster,
            namespace_labels,
            force_oracle,
            trace=tr,
        )
        tr.annotate(solver=self.last_used)
        return results

    def _solve_in_process(
        self,
        node_pools,
        instance_types_by_pool,
        pods,
        state_node_views,
        daemonset_pods,
        options,
        cluster,
        namespace_labels,
        force_oracle,
        trace=None,
    ) -> Results:
        results, scheduler = solve_in_process(
            node_pools,
            instance_types_by_pool,
            pods,
            state_node_views,
            daemonset_pods,
            options,
            cluster=cluster or ClusterSource(namespace_labels=namespace_labels or {}),
            force_oracle=force_oracle,
            trace=trace,
            device=self.device,
        )
        self.last_used = "tpu" if scheduler.used_tpu else "oracle"
        return results

    @staticmethod
    def _to_results(decoded: dict, pods: list[Pod]) -> Results:
        """Expand the decoded wire response (service.decode_result) into
        the Results shape the provisioning controller consumes."""
        uid_to_pod = {p.uid: p for p in pods}
        claims = [
            RemoteNodeClaim(
                nodepool_name=c["nodepool"],
                node_claim=c["node_claim"],
                requests=c["requests"],
                pods=[uid_to_pod[u] for u in c["pod_uids"] if u in uid_to_pod],
            )
            for c in decoded["new_node_claims"]
        ]
        by_node: dict[str, RemoteExistingNode] = {}
        for uid, node_name in decoded["existing_assignments"].items():
            node = by_node.setdefault(node_name, RemoteExistingNode(node_name))
            if uid in uid_to_pod:
                node.pods.append(uid_to_pod[uid])
        return Results(
            new_node_claims=claims,
            existing_nodes=list(by_node.values()),
            pod_errors=dict(decoded["pod_errors"]),
            timed_out=bool(decoded["timed_out"]),
        )
