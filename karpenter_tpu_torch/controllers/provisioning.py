"""The provisioning control plane: Batcher, VolumeTopology, and the
Provisioner that turns pending pods into NodeClaims.

A copy of the reference's `controllers/provisioning.py`
(provisioner.go:119-586, batcher.go:33-110, controller.go:44-125,
volumetopology.go:43-226). The Solve goes through the port's
`solve_in_process` (TorchHybridScheduler: the kernels on `device` with the
oracle for what they do not cover), so the control plane is
solver-agnostic. Pods landing on existing ready nodes are bound directly
(standing in for the kube-scheduler, which SimKube does not model); pods
landing on new claims bind on a later reconcile once the claim's node
registers.

With `solver=` (a `hybrid.ResilientSolver`), a round solves through the
sidecar boundary: the remote solver under a circuit breaker, the
in-process solve as the floor (`last_solver_used` is "sidecar", "tpu" or
"oracle"; a degraded round logs "solver degraded" with the reason). Each
round rides ONE trace (`tracing.maybe_trace(None, "provisioning")`) from
`schedule` down through the wire client or the solve driver's host
phases; `last_trace` is that trace. Beside it the Provisioner keeps
`last_scheduler` (the hybrid scheduler of the last in-process solve:
`used_tpu`, `fallback_kind`, the kernel odometer; None when the sidecar
answered) and `last_phases` (host seconds of the last reconcile's
phases).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch import logging, metrics, tracing
from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    NodeAffinity,
    NodeClaim,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Operator,
    Pod,
)
from karpenter_tpu_torch.controllers.kube import NotFound, SimKube
from karpenter_tpu_torch.controllers.state import (
    Cluster,
    cluster_source,
    is_provisionable,
    is_reschedulable,
)
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.events import Event, Recorder
from karpenter_tpu_torch.options import Options
from karpenter_tpu_torch.solver.hybrid import solve_in_process
from karpenter_tpu_torch.solver.oracle import Results, SchedulerOptions

# -- scheduler metrics (reference scheduling/metrics.go:34-95) ---------------

SCHEDULE_DURATION = metrics.REGISTRY.histogram(
    "karpenter_provisioner_scheduling_duration_seconds",
    "Duration of scheduling simulations.",
)
QUEUE_DEPTH = metrics.REGISTRY.gauge(
    "karpenter_provisioner_scheduling_queue_depth",
    "Number of pods the scheduler is attempting to schedule.",
)
IGNORED_PODS = metrics.REGISTRY.gauge(
    "karpenter_ignored_pod_count", "Pods ignored for provisioning (invalid specs)."
)
UNSCHEDULABLE_PODS = metrics.REGISTRY.gauge(
    "karpenter_pods_state", "Pods that failed to schedule.", ("state",)
)


class Batcher:
    """Dedup'd trigger batching window (batcher.go:33): the first trigger
    opens a window that closes after `idle` seconds without new triggers or
    `max_duration` seconds overall."""

    def __init__(self, clock, idle_seconds: float = 1.0, max_seconds: float = 10.0):
        self.clock = clock
        self.idle = idle_seconds
        self.max = max_seconds
        self._window_start: Optional[float] = None
        self._last_trigger: Optional[float] = None
        self._triggered_uids: set[str] = set()

    def trigger(self, uid: str = "") -> None:
        now = self.clock.now()
        if uid and uid in self._triggered_uids:
            # duplicate triggers don't extend the window (batcher.go:62)
            return
        if uid:
            self._triggered_uids.add(uid)
        if self._window_start is None:
            self._window_start = now
        self._last_trigger = now

    def ready(self) -> bool:
        """Window closed -> a provisioning run should start."""
        if self._window_start is None:
            return False
        now = self.clock.now()
        if now - self._window_start >= self.max:
            return True
        return now - self._last_trigger >= self.idle

    def reset(self) -> None:
        self._window_start = None
        self._last_trigger = None
        self._triggered_uids.clear()


class VolumeTopology:
    """PVC zone injection (volumetopology.go:43): before scheduling, rewrite
    each pod's node affinity with the zones its bound/zonal volumes demand."""

    def __init__(self, kube: SimKube):
        self.kube = kube

    def inject(self, pod: Pod) -> None:
        requirements: list[NodeSelectorRequirement] = []
        for claim_name in pod.volume_claims:
            pvc = self.kube.try_get("PersistentVolumeClaim", claim_name)
            if pvc is None:
                continue
            req = self._requirement_for(pvc)
            if req is not None:
                requirements.append(req)
            # resolve the claim's CSI driver for per-driver volume-limit
            # accounting (volumeusage.go:187: pod -> PVC -> StorageClass
            # provisioner), from the same PVC fetch as the zone resolution
            driver = self.driver_for(pvc)
            if driver:
                pod.volume_drivers[claim_name] = driver
        if not requirements:
            return
        if pod.node_affinity is None:
            pod.node_affinity = NodeAffinity()
        if not pod.node_affinity.required_terms:
            pod.node_affinity.required_terms = [NodeSelectorTerm([])]
        # the reference appends to EVERY required term (OR-semantics keep
        # each alternative zone-correct, volumetopology.go:78)
        for term in pod.node_affinity.required_terms:
            term.match_expressions = list(term.match_expressions) + requirements

    def driver_for(self, pvc) -> str:
        """The claim's CSI driver via StorageClass.provisioner ("" when
        unresolvable). Also used by the cluster cache when it tallies
        BOUND pods' volumes (state.py) — attribution must agree between
        the solve-time inject and the bound-pod accounting or per-driver
        budgets double-count into the default bucket."""
        if not pvc.storage_class_name:
            return ""
        sc = self.kube.try_get("StorageClass", pvc.storage_class_name)
        return sc.provisioner if sc is not None else ""

    def resolve_drivers(self, pod: Pod) -> None:
        """Fill pod.volume_drivers in place (claim -> CSI driver)."""
        for claim_name in pod.volume_claims:
            if claim_name in pod.volume_drivers:
                continue
            pvc = self.kube.try_get("PersistentVolumeClaim", claim_name)
            if pvc is not None:
                driver = self.driver_for(pvc)
                if driver:
                    pod.volume_drivers[claim_name] = driver

    def _requirement_for(self, pvc) -> Optional[NodeSelectorRequirement]:
        zones: list[str] = []
        if pvc.volume_zones:
            zones = list(pvc.volume_zones)  # bound volume wins
        elif pvc.storage_class_name:
            sc = self.kube.try_get("StorageClass", pvc.storage_class_name)
            if sc is not None and sc.zones:
                zones = list(sc.zones)
        if not zones:
            return None
        return NodeSelectorRequirement(
            well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, zones
        )

    def validate(self, pod: Pod) -> Optional[str]:
        """volumetopology.go:162 ValidatePersistentVolumeClaims: pods whose
        PVCs don't resolve are not schedulable."""
        for claim_name in pod.volume_claims:
            try:
                pvc = self.kube.get("PersistentVolumeClaim", claim_name)
            except NotFound:
                return f"missing persistent volume claim {claim_name!r}"
            if not pvc.volume_name and pvc.storage_class_name:
                sc = self.kube.try_get("StorageClass", pvc.storage_class_name)
                if sc is None:
                    return (
                        f"missing storage class {pvc.storage_class_name!r} "
                        f"for claim {claim_name!r}"
                    )
        return None


@dataclass
class ProvisioningResult:
    results: Optional[Results] = None
    created_claims: list[NodeClaim] = field(default_factory=list)
    bound_pods: dict[str, str] = field(default_factory=dict)  # pod name -> node
    skipped: bool = False
    reason: str = ""


_claim_name_seq = [0]


class Provisioner:
    """provisioner.go:119 Reconcile: batch -> Synced barrier -> Schedule ->
    CreateNodeClaims. Driven manually (tests and the operator call
    reconcile()); the Batcher gates when a run is due. `device` (None = the
    card, "cpu" for the plain versions) is where the kernels run; it is
    resolved here, so without a card the constructor raises. A
    `force_oracle` Provisioner runs no device code and resolves none."""

    def __init__(
        self,
        kube: SimKube,
        cluster: Cluster,
        cloud_provider,
        clock,
        options: Optional[Options] = None,
        recorder: Optional[Recorder] = None,
        force_oracle: bool = False,
        device=None,
        solver=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud_provider
        self.clock = clock
        self.opts = options or Options()
        self.recorder = recorder or Recorder(clock)
        self.volume_topology = VolumeTopology(kube)
        self.batcher = Batcher(
            clock,
            self.opts.batch_idle_duration_seconds,
            self.opts.batch_max_duration_seconds,
        )
        self.force_oracle = force_oracle
        self.device = None if force_oracle else resolve_device(device)
        # Optional sidecar boundary: a ResilientSolver (solver/hybrid.py).
        # When set, schedule() routes solves through it — remote sidecar
        # under a circuit breaker, the in-process solve as the floor.
        # None = solve in-process directly.
        self.solver = solver
        self.log = logging.root.named("provisioner")
        self.last_solver_used: Optional[str] = None
        self.last_trace = None  # the most recent schedule()'s solve trace
        self.last_scheduler = None  # the TorchHybridScheduler of the last solve
        self.last_phases: dict[str, float] = {}

    # -- triggers (provisioning/controller.go:44) ------------------------

    def trigger_pod(self, pod: Pod) -> None:
        if is_provisionable(pod):
            self.batcher.trigger(pod.uid)

    def trigger_node_deletion(self, node_name: str) -> None:
        self.batcher.trigger(f"node-deleting/{node_name}")

    # -- pending pods -----------------------------------------------------

    def get_pending_pods(self) -> list[Pod]:
        """provisioner.go:172 GetPendingPods + pod validation
        (provisioner.go:504)."""
        out = []
        ignored = 0
        for pod in self.kube.list("Pod"):
            if not is_provisionable(pod):
                continue
            err = self._validate(pod)
            if err is not None:
                ignored += 1
                self.recorder.publish(Event("Pod", pod.name, "Warning", "FailedScheduling", err))
                continue
            out.append(pod)
        IGNORED_PODS.set(float(ignored))
        return out

    def _validate(self, pod: Pod) -> Optional[str]:
        """provisioner.go:504 Validate: the karpenter-managed-label opt-out,
        node selector + required-affinity requirement validation (restricted
        labels/domains, operators, value shapes — validateNodeSelector /
        validateAffinity via v1.ValidateRequirement), then PVC checks."""
        from karpenter_tpu_torch.controllers.nodepool_aux import validate_requirement

        # karpenter.sh/nodepool DoesNotExist opt-out (provisioner.go:538)
        na = pod.node_affinity
        terms = na.required_terms if na is not None else []
        for term in terms:
            for e in term.match_expressions:
                if e.key == well_known.NODEPOOL_LABEL_KEY and e.operator == Operator.DOES_NOT_EXIST:
                    return "pod opted out of provisioning (nodepool DoesNotExist)"
        for k, v in pod.node_selector.items():
            err = validate_requirement(NodeSelectorRequirement(k, Operator.IN, [v]))
            if err is not None:
                return err
        for term in terms:
            for e in term.match_expressions:
                err = validate_requirement(e)
                if err is not None:
                    return err
        return self.volume_topology.validate(pod)

    def _reschedulable_from_deleting_nodes(self) -> list[Pod]:
        """Pods on deleting/marked nodes get re-solved so replacements are
        sized before the node drains (provisioner.go:330 & helpers.go:84)."""
        out = []
        for sn in self.cluster.state_nodes():
            if not (sn.marked_for_deletion or sn.deleting()):
                continue
            for pod in self.cluster.pods_on(sn.name):
                if is_reschedulable(pod):
                    out.append(pod)
        return out

    # -- the loop ---------------------------------------------------------

    def reconcile(self, ignore_batcher: bool = False) -> ProvisioningResult:
        if not ignore_batcher and not self.batcher.ready():
            return ProvisioningResult(skipped=True, reason="batch window open")
        self.batcher.reset()
        if not self.cluster.synced(self.kube):
            return ProvisioningResult(skipped=True, reason="cluster state not synced")
        self.last_phases = {}
        t0 = time.monotonic()
        pods = self.get_pending_pods() + self._reschedulable_from_deleting_nodes()
        self.last_phases["pending_pods"] = time.monotonic() - t0
        if not pods:
            return ProvisioningResult(skipped=True, reason="no pending pods")
        QUEUE_DEPTH.set(float(len(pods)))
        try:
            with SCHEDULE_DURATION.measure():
                results = self.schedule(pods)
        finally:
            QUEUE_DEPTH.set(0.0)
        t0 = time.monotonic()
        created = self.create_node_claims(results)
        t1 = time.monotonic()
        bound = self._bind_to_existing(results)
        self.last_phases["create_node_claims"] = t1 - t0
        self.last_phases["bind"] = time.monotonic() - t1
        self.log.info(
            "provisioning round complete",
            pods=len(pods),
            new_claims=len(created),
            bound_to_existing=len(bound),
            errors=len(results.pod_errors),
            solver=self.last_solver_used,
            timed_out=results.timed_out,
        )
        UNSCHEDULABLE_PODS.set(float(len(results.pod_errors)), {"state": "unschedulable"})
        for uid, reason in results.pod_errors.items():
            pod = next((p for p in pods if p.uid == uid), None)
            if pod is not None:
                self.recorder.publish(Event("Pod", pod.name, "Warning", "FailedScheduling", reason))
        return ProvisioningResult(results=results, created_claims=created, bound_pods=bound)

    def scheduler_inputs(self, pods: list[Pod]) -> tuple:
        """provisioner.go:303's Solve inputs from live cluster state:
        (node_pools, its_by_pool, pods, views, daemonset_pods, options,
        cluster source); the pods are deep copies with their volumes'
        zones injected."""
        node_pools = [
            np
            for np in self.kube.list("NodePool")
            if np.replicas is None  # static pools have their own loop
        ]
        its_by_pool = {np.name: self.cloud.get_instance_types(np) for np in node_pools}
        daemonset_pods = [ds.pod_template for ds in self.kube.list("DaemonSet")]
        pods = [p.deep_copy() for p in pods]
        for p in pods:
            self.volume_topology.inject(p)  # provisioner.go:286
        views = self.cluster.schedulable_node_views()
        scheduler_options = SchedulerOptions(
            ignore_preferences=self.opts.preference_policy == "Ignore",
            min_values_best_effort=self.opts.min_values_policy == "BestEffort",
            reserved_capacity_enabled=self.opts.feature_gates.reserved_capacity,
            timeout_seconds=self.opts.solve_timeout_seconds,
            claim_slot_div=self.opts.tpu_claim_slot_div,
            tpu_min_pods=self.opts.tpu_min_pods,
        )
        source = cluster_source(self.kube, self.cluster)
        return node_pools, its_by_pool, pods, views, daemonset_pods, scheduler_options, source

    def schedule(self, pods: list[Pod]) -> Results:
        """provisioner.go:303 Schedule: build scheduler inputs from live
        cluster state and run one Solve — through `solver` when one is
        set, else `solve_in_process`. The whole Solve rides ONE trace from
        here down; `last_trace` exposes it."""
        with tracing.maybe_trace(None, "provisioning") as tr:
            self.last_trace = tr
            tr.annotate(pods=len(pods))
            t0 = time.monotonic()
            with tr.span("build_inputs"):
                node_pools, its_by_pool, pods, views, daemonset_pods, options, source = self.scheduler_inputs(pods)
            self.last_phases["build_inputs"] = time.monotonic() - t0
            if self.solver is not None:
                # the resilient sidecar boundary: never raises for
                # solver-side faults — every pending pod gets a decision
                # (or a pod_error) in THIS reconcile
                results = self.solver.solve(
                    node_pools,
                    its_by_pool,
                    pods,
                    state_node_views=views,
                    daemonset_pods=daemonset_pods,
                    options=options,
                    cluster=source,
                    force_oracle=self.force_oracle,
                    trace=tr,
                )
                self.last_scheduler = None
                self.last_solver_used = self.solver.last_used
                tr.annotate(solver=self.last_solver_used)
                if self.solver.fallback_reason:
                    self.log.info(
                        "solver degraded",
                        reason=self.solver.fallback_reason,
                        solver=self.last_solver_used,
                    )
                return results
            results, scheduler = solve_in_process(
                node_pools,
                its_by_pool,
                pods,
                views,
                daemonset_pods,
                options,
                cluster=source,
                force_oracle=self.force_oracle,
                trace=tr,
                device=self.device,
            )
            self.last_scheduler = scheduler
            self.last_solver_used = "tpu" if scheduler.used_tpu else "oracle"
            tr.annotate(solver=self.last_solver_used)
            self.last_phases.update(scheduler.last_phases)
            return results

    def create_node_claims(self, results: Results) -> list[NodeClaim]:
        """provisioner.go:407 Create: persist NodeClaims for the solver's
        new nodes, update state pre-watch (provisioner.go:448)."""
        created = []
        prices: dict = {}  # launch prices shared by the round's claims (InstanceTypes.order_by_price)
        for claim in results.new_node_claims:
            if not claim.pods:
                continue
            _claim_name_seq[0] += 1
            nc = claim.to_node_claim(prices)
            nc.metadata.name = f"{claim.nodepool_name}-{_claim_name_seq[0]:05d}"
            stored = self.kube.create("NodeClaim", nc)
            created.append(stored)
            # informers already saw the create event synchronously; nominate
            # the in-flight capacity so disruption keeps its hands off
            sn = self.cluster.node_by_claim_name(stored.name)
            if sn is not None:
                sn.nominate(self.clock.now())
            self.recorder.publish(
                Event("NodeClaim", stored.name, "Normal", "Launched", f"claim for {len(claim.pods)} pods")
            )
        return created

    def _bind_to_existing(self, results: Results) -> dict[str, str]:
        """Bind pods the solver placed on ready existing nodes (standing in
        for the kube-scheduler; reference nominates and lets kube-scheduler
        bind). Only provisionable (unbound) pods bind — pods from deleting
        nodes are in the solve for replacement sizing and must go through
        the drain/eviction path, never teleport."""
        bound: dict[str, str] = {}
        assignments: dict[str, str] = {}
        for node in results.existing_nodes:
            if not node.pods:
                continue
            # in-flight claim-only views resolve by claim name
            sn = self.cluster.node_by_name(node.name) or self.cluster.node_by_claim_name(node.name)
            if sn is None:
                continue
            sn.nominate(self.clock.now())
            if sn.node is None or not sn.node.ready:
                # in-flight capacity: the placement is a DECISION (keeps
                # the nomination window fresh + the undecided metric
                # honest) but binding waits for the node to be ready
                for pod in node.pods:
                    assignments[pod.uid] = node.name
                continue
            for pod in node.pods:
                stored = self.kube.try_get("Pod", pod.name)
                if stored is None or not is_provisionable(stored):
                    continue
                try:
                    self.kube.bind(pod.name, node.name)
                except NotFound:
                    continue
                bound[pod.name] = node.name
                assignments[pod.uid] = node.name
                self.recorder.publish(Event("Pod", pod.name, "Normal", "Nominated", node.name))
        self.cluster.mark_pod_scheduling_decisions(assignments)
        return bound
