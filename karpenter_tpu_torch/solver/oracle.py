"""The sequential oracle scheduler: an exact re-implementation of the
reference's first-fit-decreasing bin-packer
(pkg/controllers/provisioning/scheduling/scheduler.go:377-675).

Role in this framework: (1) the semantic referee every TPU kernel is tested
against, and (2) the in-process CPU baseline the TPU solver's speedup is
measured from (BASELINE.md). The TPU solver (karpenter_tpu.solver.tpu)
reproduces this exact pod ordering and lowest-index-wins target selection so
results are bit-identical where kernels cover the semantics.
"""

from __future__ import annotations

import time as time_mod
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    NodePool,
    Pod,
    TaintEffect,
    Toleration,
    TopologySpreadConstraint,
    WhenUnsatisfiable,
)
from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
from karpenter_tpu_torch.scheduling import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Requirements,
    Taints,
)
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage, get_host_ports
from karpenter_tpu_torch.solver.nodes import (
    ExistingNode,
    NodeClaimTemplate,
    PodData,
    ReservationManager,
    ReservedOfferingError,
    SchedulingNodeClaim,
    StateNodeView,
    filter_instance_types,
)
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList


# ---------------------------------------------------------------------------
# queue (queue.go:31-108)


class Queue:
    """Pods sorted CPU-then-memory descending with stable tiebreak; stall
    detection via per-pod lastLen."""

    def __init__(self, pods: list[Pod], pod_data: dict[str, PodData]):
        from karpenter_tpu_torch.solver.ordering import ffd_sort_key

        self.pods = deque(
            sorted(
                pods,
                key=lambda p: ffd_sort_key(p, pod_data[p.uid].requests),
            )
        )
        self.last_len: dict[str, int] = {}

    def pop(self) -> Optional[Pod]:
        if not self.pods:
            return None
        p = self.pods[0]
        if self.last_len.get(p.uid) == len(self.pods):
            return None  # cycled through without progress
        self.pods.popleft()
        return p

    def push(self, pod: Pod) -> None:
        self.pods.append(pod)
        self.last_len[pod.uid] = len(self.pods)


# ---------------------------------------------------------------------------
# preference relaxation (preferences.go:38-161)


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        for fn in (
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity,
            self._remove_preferred_pod_anti_affinity,
            self._remove_preferred_node_affinity,
            self._remove_tsc_schedule_anyway,
        ):
            if fn(pod):
                self._invalidate_class_caches(pod)
                return True
        if self.tolerate_prefer_no_schedule and self._tolerate_prefer_no_schedule(pod):
            self._invalidate_class_caches(pod)
            return True
        return False

    @staticmethod
    def _invalidate_class_caches(pod: Pod) -> None:
        """Relaxation changes every decision-relevant field the memoized
        class key covers (solver/ordering.py); deep copies inherit the
        cached attributes, so a mutated pod must drop them or the encoder
        would dedup it into its pre-relaxation class."""
        for attr in ("_ktpu_class_key", "_ktpu_class_repr", "_ktpu_class_sig"):
            try:
                delattr(pod, attr)
            except AttributeError:
                pass

    @staticmethod
    def _remove_required_node_affinity_term(pod: Pod) -> bool:
        na = pod.node_affinity
        if na is None or len(na.required_terms) <= 1:
            return False  # can't remove the last required term
        na.required_terms = na.required_terms[1:]
        return True

    @staticmethod
    def _remove_preferred_pod_affinity(pod: Pod) -> bool:
        if not pod.pod_affinity_preferred:
            return False
        pod.pod_affinity_preferred.sort(key=lambda w: -w.weight)
        pod.pod_affinity_preferred = pod.pod_affinity_preferred[1:]
        return True

    @staticmethod
    def _remove_preferred_pod_anti_affinity(pod: Pod) -> bool:
        if not pod.pod_anti_affinity_preferred:
            return False
        pod.pod_anti_affinity_preferred.sort(key=lambda w: -w.weight)
        pod.pod_anti_affinity_preferred = pod.pod_anti_affinity_preferred[1:]
        return True

    @staticmethod
    def _remove_preferred_node_affinity(pod: Pod) -> bool:
        na = pod.node_affinity
        if na is None or not na.preferred:
            return False
        na.preferred.sort(key=lambda t: -t.weight)
        na.preferred = na.preferred[1:]
        return True

    @staticmethod
    def _remove_tsc_schedule_anyway(pod: Pod) -> bool:
        for i, tsc in enumerate(pod.topology_spread_constraints):
            if tsc.when_unsatisfiable == WhenUnsatisfiable.SCHEDULE_ANYWAY:
                # swap-remove like the reference
                last = len(pod.topology_spread_constraints) - 1
                pod.topology_spread_constraints[i] = pod.topology_spread_constraints[last]
                pod.topology_spread_constraints.pop()
                return True
        return False

    @staticmethod
    def _tolerate_prefer_no_schedule(pod: Pod) -> bool:
        marker = Toleration(operator="Exists", effect=TaintEffect.PREFER_NO_SCHEDULE)
        if any(
            t.operator == "Exists" and t.effect == TaintEffect.PREFER_NO_SCHEDULE and not t.key
            for t in pod.tolerations
        ):
            return False
        pod.tolerations = pod.tolerations + [marker]
        return True


# ---------------------------------------------------------------------------
# scheduler

# The card's small-batch crossover, the default of SchedulerOptions and of
# the operator's Options: measured by chip_smoke.py's crossover phase on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit (requests-only batches of
# 16-4096 pods on 500 KWOK types through solve_in_process; PERF.md has the
# table): a card solve costs about 0.1 s at any of these sizes, so the
# oracle is faster up to 64 pods and the card from 256 on. Topology-bearing
# problems skip the check (the oracle's domain tracking is the slow side
# there).
TPU_MIN_PODS = 256


@dataclass
class SchedulerOptions:
    ignore_preferences: bool = False  # PreferencePolicy=Ignore
    min_values_best_effort: bool = False  # MinValuesPolicy=BestEffort
    reserved_capacity_enabled: bool = False  # ReservedCapacity feature gate
    reserved_offering_strict: bool = False
    timeout_seconds: Optional[float] = None  # Solve budget (provisioner.go:366)
    # TPU solver: initial claim-slot pool = pods/claim_slot_div (pow2-
    # bucketed, grows on kernel overflow). Smaller pools cut per-step
    # candidate screens AND the decode fetch; the runs kernel pads the
    # carried state and CONTINUES on overflow (decisions are N-invariant),
    # so undersizing costs one growth event, not a re-solve.
    claim_slot_div: int = 16
    # Hybrid routing: batches below this size with NO topology groups run
    # on the oracle (TPU_MIN_PODS says why this value). 0 disables.
    tpu_min_pods: int = TPU_MIN_PODS


@dataclass
class Results:
    """scheduler.go Results."""

    new_node_claims: list[SchedulingNodeClaim]
    existing_nodes: list[ExistingNode]
    pod_errors: dict[str, str]  # pod uid -> reason
    # Solve hit its deadline: pods still in the queue were never attempted
    # (the reference surfaces this as ctx.Err() next to Results).
    timed_out: bool = False

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors and not self.timed_out

    def node_pod_counts(self) -> list[int]:
        return [len(n.pods) for n in self.new_node_claims]


class Scheduler:
    """scheduler.go:116 NewScheduler + Solve."""

    def __init__(
        self,
        node_pools: list[NodePool],
        instance_types_by_pool: dict[str, InstanceTypes],
        topology: Topology,
        state_nodes: Optional[list[StateNodeView]] = None,
        daemonset_pods: Optional[list[Pod]] = None,
        options: Optional[SchedulerOptions] = None,
    ):
        self.opts = options or SchedulerOptions()
        self.topology = topology
        # NodePools are tried in weight order (provisioner.go:262)
        node_pools = sorted(node_pools, key=lambda np: (-np.weight, np.name))
        tolerate_pns = any(
            t.effect == TaintEffect.PREFER_NO_SCHEDULE
            for np in node_pools
            for t in np.template.taints
        )
        self.preferences = Preferences(tolerate_prefer_no_schedule=tolerate_pns)
        self.reservation_manager = ReservationManager(instance_types_by_pool)

        # Pre-filter each template's instance types (scheduler.go:140-158)
        self.templates: list[NodeClaimTemplate] = []
        for np in node_pools:
            nct = NodeClaimTemplate(np)
            its, _, _ = filter_instance_types(
                instance_types_by_pool.get(np.name, InstanceTypes()),
                nct.requirements,
                {},
                {},
                {},
                self.opts.min_values_best_effort,
            )
            if not its:
                continue  # nodepool requirements filtered out all instance types
            nct.instance_type_options = its
            self.templates.append(nct)

        self.remaining_resources: dict[str, ResourceList] = {
            np.name: dict(np.limits) for np in node_pools if np.limits
        }

        daemonset_pods = daemonset_pods or []
        self.daemon_overhead: dict[NodeClaimTemplate, ResourceList] = {}
        self.daemon_host_ports: dict[NodeClaimTemplate, HostPortUsage] = {}
        for nct in self.templates:
            compatible = [
                p for p in daemonset_pods if self._daemon_compatible(nct, p)
            ]
            self.daemon_overhead[nct] = res.requests_for_pods(compatible)
            usage = HostPortUsage()
            for p in compatible:
                usage.add(p, get_host_ports(p))
            self.daemon_host_ports[nct] = usage

        self.cached_pod_data: dict[str, PodData] = {}
        self.new_node_claims: list[SchedulingNodeClaim] = []
        self.existing_nodes: list[ExistingNode] = []
        for view in sorted(
            state_nodes or [], key=lambda v: (not v.initialized, v.name)
        ):
            daemons = [
                p
                for p in daemonset_pods
                if Taints(view.taints).tolerates_pod(p) is None
                and Requirements.from_labels(view.labels).compatible(
                    Requirements.strict_from_pod(p)
                )
                is None
            ]
            self.existing_nodes.append(
                ExistingNode(
                    view, topology, list(view.taints), res.requests_for_pods(daemons)
                )
            )
            pool = view.labels.get(well_known.NODEPOOL_LABEL_KEY)
            if pool in self.remaining_resources:
                self.remaining_resources[pool] = res.subtract(
                    self.remaining_resources[pool], view.capacity
                )

    @staticmethod
    def _daemon_compatible(nct: NodeClaimTemplate, pod: Pod) -> bool:
        """scheduler.go:806 isDaemonPodCompatible: tolerate PreferNoSchedule,
        relax required node affinity terms until compatible."""
        p = pod.deep_copy()
        Preferences._tolerate_prefer_no_schedule(p)
        if Taints(nct.taints).tolerates_pod(p) is not None:
            return False
        while True:
            if nct.requirements.is_compatible(
                Requirements.strict_from_pod(p), ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            ):
                return True
            if not Preferences._remove_required_node_affinity_term(p):
                return False

    # -- solve ----------------------------------------------------------------

    def _update_cached_pod_data(self, pod: Pod) -> None:
        if self.opts.ignore_preferences:
            requirements = Requirements.strict_from_pod(pod)
        else:
            requirements = Requirements.from_pod(pod)
        strict = requirements
        if pod.node_affinity is not None and pod.node_affinity.preferred:
            strict = Requirements.strict_from_pod(pod)
        self.cached_pod_data[pod.uid] = PodData(
            # RequestsForPods semantics: every pod also consumes one unit of
            # the `pods` count resource (resources.go:30-38, scheduler.go:481)
            requests=res.requests_for_pods([pod]),
            requirements=requirements,
            strict_requirements=strict,
        )

    def solve(self, pods: list[Pod]) -> Results:
        """scheduler.go:377 Solve: loop while progress is being made — this
        (not topo-sort) is what makes batch affinities and alternating
        max-skew placements work."""
        pod_errors: dict[str, str] = {}
        for p in pods:
            self._update_cached_pod_data(p)
        q = Queue(list(pods), self.cached_pod_data)
        deadline = (
            time_mod.monotonic() + self.opts.timeout_seconds
            if self.opts.timeout_seconds
            else None
        )
        timed_out = False
        while True:
            pod = q.pop()
            if pod is None:
                break
            if deadline is not None and time_mod.monotonic() > deadline:
                timed_out = True
                break
            err = self._try_schedule(pod.deep_copy())
            if err is not None:
                pod_errors[pod.uid] = err
                self.topology.update(pod)
                self._update_cached_pod_data(pod)
                q.push(pod)
            else:
                pod_errors.pop(pod.uid, None)
        for claim in self.new_node_claims:
            claim.finalize()
        return Results(
            new_node_claims=self.new_node_claims,
            existing_nodes=self.existing_nodes,
            pod_errors=pod_errors,
            timed_out=timed_out,
        )

    def _try_schedule(self, pod: Pod) -> Optional[str]:
        """scheduler.go:434 trySchedule: relax-until-schedulable on a copy."""
        while True:
            err = self._add(pod)
            if err is None:
                return None
            if isinstance(err, ReservedOfferingError):
                return str(err)
            if not self.preferences.relax(pod):
                return err if isinstance(err, str) else str(err)
            self.topology.update(pod)
            self._update_cached_pod_data(pod)

    def _add(self, pod: Pod):
        """scheduler.go:488 add: existing nodes -> in-flight claims (sorted by
        pod count) -> new claim from templates in weight order; always the
        lowest index that accepts."""
        pod_data = self.cached_pod_data[pod.uid]
        # existing nodes first
        for node in self.existing_nodes:
            requirements, err = node.can_add(pod, pod_data)
            if err is None:
                node.add(pod, pod_data, requirements)
                return None
        # then in-flight claims, fewest pods first (scheduler.go:499)
        self.new_node_claims.sort(key=lambda c: len(c.pods))
        for claim in self.new_node_claims:
            try:
                requirements, its, offerings, err = claim.can_add(
                    pod, pod_data, self.opts.min_values_best_effort
                )
            except ReservedOfferingError:
                continue
            if err is None:
                claim.add(pod, pod_data, requirements, its, offerings)
                return None
        if not self.templates:
            return "nodepool requirements filtered out all available instance types"
        # then a new claim per template in weight order
        errs = []
        for nct in self.templates:
            its = nct.instance_type_options
            if nct.nodepool_name in self.remaining_resources:
                its = InstanceTypes(
                    _filter_by_remaining_resources(
                        its, self.remaining_resources[nct.nodepool_name]
                    )
                )
                if not its:
                    errs.append(
                        f"all available instance types exceed limits for nodepool "
                        f"{nct.nodepool_name!r}"
                    )
                    continue
            claim = SchedulingNodeClaim(
                nct,
                self.topology,
                self.daemon_overhead[nct],
                self.daemon_host_ports[nct],
                its,
                self.reservation_manager,
                reserved_offering_strict=self.opts.reserved_offering_strict,
                reserved_capacity_enabled=self.opts.reserved_capacity_enabled,
            )
            try:
                requirements, its2, offerings, err = claim.can_add(
                    pod, pod_data, self.opts.min_values_best_effort
                )
            except ReservedOfferingError as roe:
                return roe
            if err is not None:
                errs.append(err)
                continue
            claim.add(pod, pod_data, requirements, its2, offerings)
            self.new_node_claims.append(claim)
            if claim.nodepool_name in self.remaining_resources:
                self.remaining_resources[claim.nodepool_name] = _subtract_max(
                    self.remaining_resources[claim.nodepool_name],
                    claim.instance_type_options,
                )
            return None
        return "; ".join(errs) if errs else "failed to schedule pod"


def _subtract_max(remaining: ResourceList, instance_types: InstanceTypes) -> ResourceList:
    """Pessimistically subtract the max capacity over surviving instance types
    (scheduler.go:831 subtractMax)."""
    if not instance_types:
        return remaining
    max_caps = res.max_resources(*(it.capacity for it in instance_types))
    return {k: v - max_caps.get(k, 0) for k, v in remaining.items()}


def _filter_by_remaining_resources(instance_types, remaining: ResourceList):
    """Drop instance types whose capacity would breach nodepool limits
    (scheduler.go:851 filterByRemainingResources)."""
    out = []
    for it in instance_types:
        if all(it.capacity.get(name, 0) <= rem for name, rem in remaining.items()):
            out.append(it)
    return out
