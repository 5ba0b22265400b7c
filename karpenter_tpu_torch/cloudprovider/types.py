"""CloudProvider SPI: the pluggable boundary between the control plane and a
cloud (reference pkg/cloudprovider/types.go:72-585).

InstanceType/Offering are the *data* contract the solver consumes: every
scheduling decision reduces to (requirements, offerings, capacity) tensors
built from these objects by karpenter_tpu.ops.encode.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import NodeClaim, NodePool
from karpenter_tpu_torch.scheduling import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Requirements,
)
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList

MAX_FLOAT = float("inf")


# ---------------------------------------------------------------------------
# typed errors (types.go:477-585)


class InsufficientCapacityError(Exception):
    """The cloud cannot fulfill the requested capacity right now."""


class NodeClaimNotFoundError(Exception):
    """The instance backing a NodeClaim no longer exists."""


class NodeClassNotReadyError(Exception):
    """The NodeClass referenced by a NodeClaim isn't ready for launches."""


class CreateError(Exception):
    """Create failed; carries a condition reason for NodeRegistrationHealthy."""

    def __init__(self, message: str, reason: str = "LaunchFailed"):
        super().__init__(message)
        self.reason = reason


# ---------------------------------------------------------------------------
# Offering


@dataclass
class Offering:
    """A sellable variant of an instance type: (zone x capacity-type [x
    reservation]) with a price and availability (types.go:355-405)."""

    requirements: Requirements
    price: float
    available: bool = True
    # remaining capacity for `reserved` offerings
    reservation_capacity: int = 0

    def capacity_type(self) -> str:
        return self.requirements.get(well_known.CAPACITY_TYPE_LABEL_KEY).any_value()

    def zone(self) -> str:
        return self.requirements.get(well_known.TOPOLOGY_ZONE_LABEL_KEY).any_value()

    def reservation_id(self) -> str:
        return self.requirements.get(well_known.RESERVATION_ID_LABEL_KEY).any_value()


class Offerings(list):
    """Decorated list of Offering (types.go:407-475)."""

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        return Offerings(
            o
            for o in self
            if reqs.is_compatible(o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
        )

    def has_compatible(self, reqs: Requirements) -> bool:
        return any(
            reqs.is_compatible(o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS) for o in self
        )

    def cheapest_launch_price(self, reqs: Requirements) -> float:
        return min(
            (o.price for o in self.compatible(reqs)),
            default=MAX_FLOAT,
        )

    def worst_launch_price(self, reqs: Requirements) -> float:
        """Most expensive compatible offering — the pessimistic launch price
        used by consolidation (types.go WorstLaunchPrice)."""
        return max(
            (o.price for o in self.compatible(reqs)),
            default=MAX_FLOAT,
        )


# ---------------------------------------------------------------------------
# InstanceType


@dataclass
class InstanceTypeOverhead:
    """Resources consumed before pods can use the node (types.go:340-353)."""

    kube_reserved: ResourceList = field(default_factory=dict)
    system_reserved: ResourceList = field(default_factory=dict)
    eviction_threshold: ResourceList = field(default_factory=dict)

    def total(self) -> ResourceList:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class InstanceType:
    """name + requirements + offerings + capacity + overhead
    (types.go:105-179)."""

    name: str
    requirements: Requirements
    offerings: Offerings
    capacity: ResourceList
    overhead: InstanceTypeOverhead = field(default_factory=InstanceTypeOverhead)
    _allocatable: Optional[ResourceList] = field(default=None, repr=False, compare=False)

    def allocatable(self) -> ResourceList:
        """capacity - overhead, with hugepage reservations deducted from
        memory (types.go:181-199 precompute); memoized."""
        if self._allocatable is None:
            alloc = res.subtract(self.capacity, self.overhead.total())
            for name, qty in self.capacity.items():
                if name.startswith(res.HUGEPAGES_PREFIX):
                    alloc[res.MEMORY] = max(alloc.get(res.MEMORY, 0) - qty, 0)
            self._allocatable = alloc
        return self._allocatable


class InstanceTypes(list):
    """Decorated list of InstanceType (types.go:221-334)."""

    def order_by_price(self, reqs: Requirements, prices: Optional[dict] = None) -> "InstanceTypes":
        """Sort by cheapest available+compatible offering price
        (types.go:221 OrderByPrice). Stable, in-place like the reference.

        `prices` (optional, a dict the caller owns while the instance types
        live) memoizes launch prices across calls: a type's price depends
        on `reqs` only through the keys its offerings constrain, so calls
        whose requirements agree on those keys share it. The Provisioner
        passes one for all the claims of a round."""

        def launch_price(it: InstanceType) -> float:
            return min(
                (
                    o.price
                    for o in it.offerings
                    if o.available
                    and reqs.is_compatible(o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
                ),
                default=MAX_FLOAT,
            )

        if prices is None:
            self.sort(key=launch_price)
            return self
        sigs: dict[str, tuple] = {}

        def sig(key: str):
            if key not in sigs:
                r = reqs.get(key) if reqs.has(key) else None
                sigs[key] = None if r is None else (
                    r.complement, frozenset(r.values), r.greater_than, r.less_than, r.min_values
                )
            return sigs[key]

        def memo_price(it: InstanceType) -> float:
            entry = prices.get(id(it))
            if entry is None:
                keys = sorted({k for o in it.offerings for k in o.requirements})
                entry = prices[id(it)] = (it, keys, {})  # the type is held, so its id stays its own
            _, keys, by_sig = entry
            at = tuple(sig(k) for k in keys)
            if at not in by_sig:
                by_sig[at] = launch_price(it)
            return by_sig[at]

        self.sort(key=memo_price)
        return self

    def compatible(self, reqs: Requirements) -> "InstanceTypes":
        return InstanceTypes(
            it for it in self if it.offerings.available().has_compatible(reqs)
        )

    def satisfies_min_values(
        self, reqs: Requirements
    ) -> tuple[int, dict[str, int], Optional[str]]:
        """Walk the (pre-sorted) list accumulating distinct values per
        min-values key; returns (min needed instance types, unsatisfiable
        keys -> distinct count, error) (types.go:284 SatisfiesMinValues)."""
        if not reqs.has_min_values():
            return 0, {}, None
        incompatible: dict[str, int] = {}
        values_for_key: dict[str, set[str]] = {}
        min_keys = [r.key for r in reqs.values() if r.min_values is not None]
        for i, it in enumerate(self):
            for key in min_keys:
                values_for_key.setdefault(key, set()).update(it.requirements.get(key).values)
            for key, vals in values_for_key.items():
                needed = reqs.get(key).min_values or 0
                if len(vals) < needed:
                    incompatible[key] = len(vals)
                else:
                    incompatible.pop(key, None)
            if not incompatible:
                return i + 1, {}, None
        if incompatible:
            return (
                len(self),
                incompatible,
                f"minValues requirement is not met for label(s) {sorted(incompatible)}",
            )
        return len(self), {}, None

    def truncate(
        self, reqs: Requirements, max_items: int, best_effort_min_values: bool = False
    ) -> tuple["InstanceTypes", Optional[str]]:
        """Order by price and cap at max_items, refusing if that would violate
        minValues (types.go:322 Truncate)."""
        truncated = InstanceTypes(self.order_by_price(reqs)[:max_items])
        if reqs.has_min_values() and not best_effort_min_values:
            _, _, err = truncated.satisfies_min_values(reqs)
            if err is not None:
                return InstanceTypes(self), f"validating minValues, {err}"
        return truncated, None


# ---------------------------------------------------------------------------
# repair policies + SPI


@dataclass
class RepairPolicy:
    """An unhealthy-node condition the provider wants remediated
    (types.go RepairPolicy)."""

    condition_type: str
    condition_status: str = "False"
    toleration_seconds: float = 30 * 60


class CloudProvider(abc.ABC):
    """The provider SPI (types.go:72-100)."""

    @abc.abstractmethod
    def create(self, node_claim: NodeClaim) -> NodeClaim:
        """Launch an instance fulfilling the NodeClaim; returns the claim with
        provider_id/capacity/allocatable status populated."""

    @abc.abstractmethod
    def delete(self, node_claim: NodeClaim) -> None:
        """Terminate the backing instance; NodeClaimNotFoundError if gone."""

    @abc.abstractmethod
    def get(self, provider_id: str) -> NodeClaim:
        """Fetch the claim-shaped view of a live instance."""

    @abc.abstractmethod
    def list(self) -> list[NodeClaim]:
        """All live instances owned by this provider."""

    @abc.abstractmethod
    def get_instance_types(self, node_pool: NodePool) -> InstanceTypes:
        """Instance types launchable for the given NodePool."""

    @abc.abstractmethod
    def is_drifted(self, node_claim: NodeClaim) -> str:
        """Non-empty drift reason if the instance no longer matches its spec."""

    def repair_policies(self) -> list[RepairPolicy]:
        return []

    @abc.abstractmethod
    def name(self) -> str: ...


# A decorator provider that records SPI call latency/counts lives in
# karpenter_tpu.cloudprovider.metrics (reference pkg/cloudprovider/metrics).
