"""In-flight scheduling nodes: NodeClaimTemplate, NodeClaim (hypothetical node
being packed), ExistingNode (real node being packed), ReservationManager, and
instance-type filtering.

Reference:
- NodeClaimTemplate  pkg/controllers/provisioning/scheduling/nodeclaimtemplate.go:46-123
- NodeClaim          .../nodeclaim.go:83-268
- ExistingNode       .../existingnode.go:29-119
- ReservationManager .../reservationmanager.go:28-110
- filterInstanceTypesByRequirements .../nodeclaim.go:373-441
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api import objects as api
from karpenter_tpu_torch.api.objects import NodePool, Operator, Pod, Taint
from karpenter_tpu_torch.cloudprovider.types import InstanceType, InstanceTypes, Offering
from karpenter_tpu_torch.scheduling import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Requirement,
    Requirements,
    Taints,
)
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage, get_host_ports
from karpenter_tpu_torch.scheduling.volumeusage import VolumeUsage, volume_limit
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList

# Max instance types sent for launch (nodeclaimtemplate.go:41)
MAX_INSTANCE_TYPES = 600

_hostname_seq = itertools.count(1)


def next_placeholder_hostname() -> str:
    """The shared synthetic-hostname sequence (nodeclaim.go:92). Every
    code path that fabricates a claim — the oracle and the TPU decode —
    MUST draw from this one counter: independent counters collide, merging
    two claims' topology domain counts (see the hybrid continuation
    regression in tests/test_hybrid.py)."""
    return f"hostname-placeholder-{next(_hostname_seq):04d}"


@dataclass
class PodData:
    """Pre-computed pod scheduling data (scheduler.go:186 PodData)."""

    requests: ResourceList
    requirements: Requirements
    strict_requirements: Requirements


class ReservedOfferingError(Exception):
    """Pod couldn't be placed due to reserved-offering constraints; the
    relaxation ladder must NOT run for these (nodeclaim.go:62)."""


# ---------------------------------------------------------------------------
# ReservationManager


class ReservationManager:
    """Counts remaining capacity of `reserved` offerings; reservations are
    idempotent per hostname (reservationmanager.go:28)."""

    def __init__(self, instance_types_by_pool: dict[str, InstanceTypes]):
        self.capacity: dict[str, int] = {}
        self.reservations: dict[str, set[str]] = {}  # hostname -> reservation ids
        for its in instance_types_by_pool.values():
            for it in its:
                for o in it.offerings:
                    if o.capacity_type() != well_known.CAPACITY_TYPE_RESERVED:
                        continue
                    rid = o.reservation_id()
                    # track the minimum amongst duplicates for safety
                    if rid not in self.capacity or o.reservation_capacity < self.capacity[rid]:
                        self.capacity[rid] = o.reservation_capacity

    def can_reserve(self, hostname: str, offering: Offering) -> bool:
        rid = offering.reservation_id()
        if rid in self.reservations.get(hostname, ()):
            return True
        return self.capacity.get(rid, 0) > 0

    def reserve(self, hostname: str, *offerings: Offering) -> None:
        for o in offerings:
            rid = o.reservation_id()
            held = self.reservations.setdefault(hostname, set())
            if rid in held:
                continue
            self.capacity[rid] = self.capacity.get(rid, 0) - 1
            held.add(rid)

    def release(self, hostname: str, *offerings: Offering) -> None:
        for o in offerings:
            rid = o.reservation_id()
            held = self.reservations.get(hostname)
            if held and rid in held:
                held.discard(rid)
                self.capacity[rid] = self.capacity.get(rid, 0) + 1


# ---------------------------------------------------------------------------
# instance-type filtering


@dataclass
class InstanceTypeFilterError:
    """Rich scheduling-failure diagnostics (nodeclaim.go:296): which of the
    three criteria (requirements / fits / offering) excluded all types."""

    requirements_met: bool = False
    fits: bool = False
    has_offering: bool = False
    requirements_and_fits: bool = False
    requirements_and_offering: bool = False
    fits_and_offering: bool = False
    min_values_err: Optional[str] = None
    requirements: Optional[Requirements] = None
    pod_requests: Optional[ResourceList] = None
    daemon_requests: Optional[ResourceList] = None

    def __str__(self) -> str:
        resources_str = res.to_string(
            res.merge(self.daemon_requests or {}, self.pod_requests or {})
        )
        suffix = f"requirements={self.requirements!r}, resources={resources_str}"
        if self.min_values_err:
            return f"{self.min_values_err}, {suffix}"
        if not self.requirements_met and not self.fits and not self.has_offering:
            return (
                "no instance type met the scheduling requirements or had enough "
                f"resources or had a required offering, {suffix}"
            )
        if not self.requirements_met and not self.fits:
            return f"no instance type met the scheduling requirements or had enough resources, {suffix}"
        if not self.requirements_met and not self.has_offering:
            return f"no instance type met the scheduling requirements or had a required offering, {suffix}"
        if not self.fits and not self.has_offering:
            return f"no instance type had enough resources or had a required offering, {suffix}"
        if not self.requirements_met:
            return f"no instance type met all requirements, {suffix}"
        if not self.fits:
            return f"no instance type has enough resources, {suffix}"
        if not self.has_offering:
            return f"no instance type has the required offering, {suffix}"
        if self.requirements_and_fits:
            return (
                "no instance type which met the scheduling requirements and had "
                f"enough resources, had a required offering, {suffix}"
            )
        if self.fits_and_offering:
            return (
                "no instance type which had enough resources and the required "
                f"offering met the scheduling requirements, {suffix}"
            )
        if self.requirements_and_offering:
            return (
                "no instance type which met the scheduling requirements and the "
                f"required offering had the required resources, {suffix}"
            )
        return f"no instance type met the requirements/resources/offering tuple, {suffix}"


def filter_instance_types(
    instance_types: Iterable[InstanceType],
    requirements: Requirements,
    pod_requests: ResourceList,
    daemon_requests: ResourceList,
    total_requests: ResourceList,
    relax_min_values: bool = False,
) -> tuple[InstanceTypes, dict[str, int], Optional[InstanceTypeFilterError]]:
    """nodeclaim.go:373 filterInstanceTypesByRequirements: keep instance types
    that are (a) requirement-compatible, (b) fit the accumulated requests, and
    (c) have an available compatible offering; track per-criterion bits for
    error reporting and enforce minValues."""
    err = InstanceTypeFilterError(
        requirements=requirements,
        pod_requests=pod_requests,
        daemon_requests=daemon_requests,
    )
    remaining = InstanceTypes()
    for it in instance_types:
        it_compat = it.requirements.intersects(requirements) is None
        it_fits = res.fits(total_requests, it.allocatable())
        it_has_offering = any(
            o.available
            and requirements.is_compatible(
                o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            )
            for o in it.offerings
        )
        err.requirements_met = err.requirements_met or it_compat
        err.fits = err.fits or it_fits
        err.has_offering = err.has_offering or it_has_offering
        err.requirements_and_fits = err.requirements_and_fits or (
            it_compat and it_fits and not it_has_offering
        )
        err.requirements_and_offering = err.requirements_and_offering or (
            it_compat and it_has_offering and not it_fits
        )
        err.fits_and_offering = err.fits_and_offering or (
            it_fits and it_has_offering and not it_compat
        )
        if it_compat and it_fits and it_has_offering:
            remaining.append(it)

    unsatisfiable: dict[str, int] = {}
    if requirements.has_min_values():
        _, unsatisfiable, min_err = remaining.satisfies_min_values(requirements)
        if min_err is not None:
            if not relax_min_values:
                err.min_values_err = min_err
                remaining = InstanceTypes()
    if not remaining:
        return InstanceTypes(), unsatisfiable, err
    return remaining, unsatisfiable, None


# ---------------------------------------------------------------------------
# NodeClaimTemplate


class NodeClaimTemplate:
    """Per-NodePool launch template (nodeclaimtemplate.go:46)."""

    def __init__(self, node_pool: NodePool):
        self.nodepool_name = node_pool.name
        self.nodepool_uid = node_pool.metadata.uid
        self.weight = node_pool.weight
        self.is_static = node_pool.replicas is not None
        spec = node_pool.template
        self.taints: list[Taint] = list(spec.taints)
        self.startup_taints: list[Taint] = list(spec.startup_taints)
        self.node_class_ref = spec.node_class_ref
        self.expire_after_seconds = spec.expire_after_seconds
        self.termination_grace_period_seconds = spec.termination_grace_period_seconds
        self.labels = dict(spec.labels)
        self.labels[well_known.NODEPOOL_LABEL_KEY] = node_pool.name
        self.annotations = dict(spec.annotations)
        self.requirements = Requirements()
        self.requirements.add(
            *Requirements.from_node_selector_requirements(spec.requirements).values()
        )
        self.requirements.add(*Requirements.from_labels(self.labels).values())
        self.instance_type_options: InstanceTypes = InstanceTypes()

    def to_node_claim(
        self, requirements: Requirements, instance_types: InstanceTypes, prices: Optional[dict] = None
    ) -> api.NodeClaim:
        """Produce the launchable NodeClaim: price-ordered instance types
        truncated to MAX_INSTANCE_TYPES injected as an In requirement
        (nodeclaimtemplate.go:79 ToNodeClaim); `prices` is
        InstanceTypes.order_by_price's memo."""
        reqs = requirements.copy()
        if not self.is_static:
            ordered = InstanceTypes(instance_types).order_by_price(reqs, prices)[:MAX_INSTANCE_TYPES]
            reqs.add(
                Requirement(
                    well_known.INSTANCE_TYPE_LABEL_KEY,
                    Operator.IN,
                    [it.name for it in ordered],
                    min_values=reqs.get(well_known.INSTANCE_TYPE_LABEL_KEY).min_values,
                )
            )
        nc = api.NodeClaim(
            metadata=api.ObjectMeta(
                name=f"{self.nodepool_name}-{api.new_uid()[:8]}",
                labels=dict(self.labels),
                annotations=dict(self.annotations),
            ),
            requirements=reqs.to_node_selector_requirements(),
            taints=list(self.taints),
            startup_taints=list(self.startup_taints),
            node_class_ref=self.node_class_ref,
            expire_after_seconds=self.expire_after_seconds,
            termination_grace_period_seconds=self.termination_grace_period_seconds,
        )
        return nc


# ---------------------------------------------------------------------------
# NodeClaim (in-flight)


class SchedulingNodeClaim:
    """A hypothetical node being packed (nodeclaim.go:40 NodeClaim)."""

    def __init__(
        self,
        template: NodeClaimTemplate,
        topology: Topology,
        daemon_resources: ResourceList,
        daemon_host_port_usage: HostPortUsage,
        instance_types: InstanceTypes,
        reservation_manager: ReservationManager,
        reserved_offering_strict: bool = False,
        reserved_capacity_enabled: bool = False,
    ):
        self.template = template
        self.hostname = next_placeholder_hostname()
        self.requirements = Requirements(template.requirements.values())
        self.requirements.add(
            Requirement(well_known.HOSTNAME_LABEL_KEY, Operator.IN, [self.hostname])
        )
        self.instance_type_options = InstanceTypes(instance_types)
        self.requests: ResourceList = dict(daemon_resources)
        self.daemon_resources = daemon_resources
        self.pods: list[Pod] = []
        self.topology = topology
        self.host_port_usage = daemon_host_port_usage.copy()
        self.reservation_manager = reservation_manager
        self.reserved_offerings: list[Offering] = []
        self.reserved_offering_strict = reserved_offering_strict
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self.annotations: dict[str, str] = dict(template.annotations)

    @property
    def nodepool_name(self) -> str:
        return self.template.nodepool_name

    def can_add(
        self, pod: Pod, pod_data: PodData, relax_min_values: bool = False
    ) -> tuple[
        Optional[Requirements],
        Optional[InstanceTypes],
        Optional[list[Offering]],
        Optional[str],
    ]:
        """Taints -> host ports -> requirements -> topology -> instance-type
        filter -> reserved offerings (nodeclaim.go:114 CanAdd). Returns
        (requirements, instance types, offerings-to-reserve, error)."""
        err = Taints(self.template.taints).tolerates_pod(pod)
        if err is not None:
            return None, None, None, err
        hp_err = self.host_port_usage.conflicts(pod, get_host_ports(pod))
        if hp_err is not None:
            return None, None, None, f"checking host port usage, {hp_err}"
        requirements = Requirements(self.requirements.values())
        compat_err = requirements.compatible(
            pod_data.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if compat_err is not None:
            return None, None, None, f"incompatible requirements, {compat_err}"
        requirements.add(*pod_data.requirements.values())

        topo_reqs, topo_err = self.topology.add_requirements(
            pod,
            self.template.taints,
            pod_data.strict_requirements,
            requirements,
            ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
        )
        if topo_err is not None:
            return None, None, None, topo_err
        compat_err = requirements.compatible(topo_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
        if compat_err is not None:
            return None, None, None, compat_err
        requirements.add(*topo_reqs.values())

        total = res.merge(self.requests, pod_data.requests)
        remaining, unsatisfiable, filter_err = filter_instance_types(
            self.instance_type_options,
            requirements,
            pod_data.requests,
            self.daemon_resources,
            total,
            relax_min_values,
        )
        if relax_min_values:
            for key, min_values in unsatisfiable.items():
                requirements.get(key).min_values = min_values
        if filter_err is not None:
            return None, None, None, str(filter_err)
        offerings, reserve_err = self._offerings_to_reserve(remaining, requirements)
        if reserve_err is not None:
            raise ReservedOfferingError(reserve_err)
        return requirements, remaining, offerings, None

    def add(
        self,
        pod: Pod,
        pod_data: PodData,
        requirements: Requirements,
        instance_types: InstanceTypes,
        offerings_to_reserve: list[Offering],
    ) -> None:
        """nodeclaim.go:168 Add."""
        self.pods.append(pod)
        self.instance_type_options = instance_types
        self.requests = res.merge(self.requests, pod_data.requests)
        self.requirements = requirements
        self.topology.register(well_known.HOSTNAME_LABEL_KEY, self.hostname)
        self.topology.record(
            pod, self.template.taints, requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        self.host_port_usage.add(pod, get_host_ports(pod))
        self.reservation_manager.reserve(self.hostname, *offerings_to_reserve)
        updated = {o.reservation_id() for o in offerings_to_reserve}
        for o in self.reserved_offerings:
            if o.reservation_id() not in updated:
                self.reservation_manager.release(self.hostname, o)
        self.reserved_offerings = list(offerings_to_reserve)

    def _offerings_to_reserve(
        self, instance_types: InstanceTypes, requirements: Requirements
    ) -> tuple[list[Offering], Optional[str]]:
        """nodeclaim.go:201 offeringsToReserve."""
        if not self.reserved_capacity_enabled:
            return [], None
        has_compatible = False
        reserved: list[Offering] = []
        for it in instance_types:
            for o in it.offerings:
                if (
                    o.capacity_type() != well_known.CAPACITY_TYPE_RESERVED
                    or not o.available
                ):
                    continue
                if not requirements.is_compatible(
                    o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                ):
                    continue
                has_compatible = True
                if self.reservation_manager.can_reserve(self.hostname, o):
                    reserved.append(o)
        if self.reserved_offering_strict:
            if has_compatible and not reserved:
                return [], (
                    "one or more instance types with compatible reserved offerings "
                    "are available, but could not be reserved"
                )
            if self.reserved_offerings and not reserved:
                return [], (
                    "satisfying updated nodeclaim constraints would remove all "
                    "compatible reserved offering options"
                )
        return reserved, None

    def finalize(self) -> None:
        """Strip the synthetic hostname, inject reservation requirements
        (nodeclaim.go:252 FinalizeScheduling)."""
        self.requirements.pop(well_known.HOSTNAME_LABEL_KEY)
        if self.reserved_offerings:
            self.requirements._reqs[well_known.CAPACITY_TYPE_LABEL_KEY] = Requirement(
                well_known.CAPACITY_TYPE_LABEL_KEY,
                Operator.IN,
                [well_known.CAPACITY_TYPE_RESERVED],
            )
            self.requirements.add(
                Requirement(
                    well_known.RESERVATION_ID_LABEL_KEY,
                    Operator.IN,
                    [o.reservation_id() for o in self.reserved_offerings],
                )
            )

    def to_node_claim(self, prices: Optional[dict] = None) -> api.NodeClaim:
        nc = self.template.to_node_claim(self.requirements, self.instance_type_options, prices)
        nc.resources_requests = dict(self.requests)
        nc.metadata.annotations[well_known.NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY] = (
            "true"
            if any(
                (r.min_values is not None)
                and (self.template.requirements.get(r.key).min_values or 0) > r.min_values
                for r in self.requirements.values()
            )
            else "false"
        )
        return nc


# ---------------------------------------------------------------------------
# ExistingNode


@dataclass
class StateNodeView:
    """The slice of cluster-state a scheduling simulation needs about a live
    or in-flight node. Produced by the control plane's state cache (M6) or
    synthesized in tests (reference: state.StateNode)."""

    name: str
    node_labels: Optional[dict[str, str]] = None  # None while claim is in flight
    labels: dict[str, str] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    available: ResourceList = field(default_factory=dict)
    capacity: ResourceList = field(default_factory=dict)
    daemonset_requests: ResourceList = field(default_factory=dict)
    initialized: bool = False
    hostname: str = ""
    host_port_usage: HostPortUsage = field(default_factory=HostPortUsage)
    volume_usage: VolumeUsage = field(default_factory=VolumeUsage)
    # CSINode allocatable equivalent: attachable volumes per CSI driver
    # (reference volumeusage.go:187); merged with the label-derived default
    csi_allocatable: dict = field(default_factory=dict)
    # set by the scheduler when a pod is nominated to this node
    nominations: int = 0

    def __post_init__(self):
        if not self.hostname:
            self.hostname = self.labels.get(well_known.HOSTNAME_LABEL_KEY, self.name)


class ExistingNode:
    """existingnode.go:29."""

    def __init__(
        self,
        view: StateNodeView,
        topology: Topology,
        taints: list[Taint],
        daemon_resources: ResourceList,
    ):
        self.view = view
        self.cached_taints = taints
        self.topology = topology
        self.pods: list[Pod] = []
        remaining_daemon = res.subtract(daemon_resources, view.daemonset_requests)
        for k, v in list(remaining_daemon.items()):
            if v < 0:
                remaining_daemon[k] = 0
        self.remaining_resources = res.subtract(view.available, remaining_daemon)
        self.requirements = Requirements.from_labels(view.labels)
        self.requirements.add(
            Requirement(well_known.HOSTNAME_LABEL_KEY, Operator.IN, [view.hostname])
        )
        self.host_port_usage = view.host_port_usage.copy()
        self.volume_usage = view.volume_usage.copy()
        # per-driver limits: CSINode allocatable wins per driver; the node
        # label provides the default "" bucket (volumeusage.go:187)
        limits = dict(view.csi_allocatable or {})
        label_default = volume_limit(view.labels)
        if label_default is not None:
            limits.setdefault("", label_default)
        self.volume_limits = limits or None
        topology.register(well_known.HOSTNAME_LABEL_KEY, view.hostname)

    @property
    def name(self) -> str:
        return self.view.name

    def can_add(
        self, pod: Pod, pod_data: PodData
    ) -> tuple[Optional[Requirements], Optional[str]]:
        """existingnode.go:70 CanAdd. NOTE: no allow-undefined option — custom
        labels must exist on real nodes."""
        err = Taints(self.cached_taints).tolerates_pod(pod)
        if err is not None:
            return None, err
        hp_err = self.host_port_usage.conflicts(pod, get_host_ports(pod))
        if hp_err is not None:
            return None, f"checking host port usage, {hp_err}"
        vol_err = self.volume_usage.exceeds_limit(pod, self.volume_limits)
        if vol_err is not None:
            return None, f"checking volume usage, {vol_err}"
        if not res.fits(pod_data.requests, self.remaining_resources):
            return None, "exceeds node resources"
        compat_err = self.requirements.compatible(pod_data.requirements)
        if compat_err is not None:
            return None, compat_err
        requirements = Requirements(self.requirements.values())
        requirements.add(*pod_data.requirements.values())
        topo_reqs, topo_err = self.topology.add_requirements(
            pod, self.cached_taints, pod_data.strict_requirements, requirements
        )
        if topo_err is not None:
            return None, topo_err
        compat_err = requirements.compatible(topo_reqs)
        if compat_err is not None:
            return None, compat_err
        requirements.add(*topo_reqs.values())
        return requirements, None

    def add(self, pod: Pod, pod_data: PodData, requirements: Requirements) -> None:
        self.pods.append(pod)
        res.subtract_from(self.remaining_resources, pod_data.requests)
        self.requirements = requirements
        self.topology.record(pod, self.cached_taints, requirements)
        self.host_port_usage.add(pod, get_host_ports(pod))
        self.volume_usage.add(pod)
