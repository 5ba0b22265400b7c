"""NodeOverlay: price/capacity patches over instance types.

Reference pkg/controllers/nodeoverlay/ (+ the NodeOverlay
v1alpha1 CRD and designs/node-overlay.md): operators declare overlays that
adjust instance-type prices (absolute or percentage) or inject extra
capacity for matching types; overlays evaluate in weight order, conflicts
are detected, and results land in a swap-on-write InstanceTypeStore the
overlay cloud-provider decorator reads.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, ObjectMeta
from karpenter_tpu_torch.cloudprovider.decorators import InstanceTypeStore
from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.utils import resources as res


@dataclass
class NodeOverlay:
    """The NodeOverlay CRD (v1alpha1): a selector over instance types plus
    one patch."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # which instance types the overlay hits (reqs over type requirements)
    requirements: list[NodeSelectorRequirement] = field(default_factory=list)
    weight: int = 0
    # exactly one of:
    price: Optional[float] = None  # absolute price override
    price_adjustment: Optional[str] = None  # "+10%", "-5%", "+0.01", "-0.02"
    capacity: dict = field(default_factory=dict)  # extra capacity resources

    @property
    def name(self) -> str:
        return self.metadata.name

    def validate(self) -> Optional[str]:
        set_fields = [
            f
            for f, v in (
                ("price", self.price),
                ("priceAdjustment", self.price_adjustment),
                ("capacity", self.capacity or None),
            )
            if v is not None
        ]
        if len(set_fields) > 1:
            return f"conflicting overlay fields: {', '.join(set_fields)}"
        if not set_fields:
            return "overlay patches nothing"
        if self.price_adjustment is not None:
            raw = self.price_adjustment.strip()
            if not raw or raw[0] not in "+-":
                return "priceAdjustment must start with + or -"
            body = raw[1:-1] if raw.endswith("%") else raw[1:]
            try:
                float(body)
            except ValueError:
                return f"invalid priceAdjustment {raw!r}"
        return None

    def adjusted_price(self, price: float) -> float:
        if self.price is not None:
            return self.price
        raw = self.price_adjustment.strip()
        sign = 1.0 if raw[0] == "+" else -1.0
        if raw.endswith("%"):
            return max(0.0, price * (1.0 + sign * float(raw[1:-1]) / 100.0))
        return max(0.0, price + sign * float(raw[1:]))


class NodeOverlayController:
    """nodeoverlay/controller.go:69: re-evaluate overlays into the store
    whenever overlays or instance types change."""

    def __init__(self, kube, cloud_provider, store: InstanceTypeStore):
        self.kube = kube
        self.cloud = cloud_provider
        self.store = store

    def reconcile_all(self) -> dict[str, str]:
        """Returns overlay name -> validation error for bad overlays."""
        overlays = sorted(
            self.kube.list("NodeOverlay"), key=lambda o: (-o.weight, o.name)
        )
        problems: dict[str, str] = {}
        active: list[NodeOverlay] = []
        for o in overlays:
            err = o.validate()
            if err is not None:
                problems[o.name] = err
                continue
            active.append(o)
        for np in self.kube.list("NodePool"):
            base = self.cloud.get_instance_types(np)
            self.store.update(np.name, self._apply(active, base))
        return problems

    def _apply(self, overlays: list[NodeOverlay], its) -> InstanceTypes:
        if not overlays:
            return its
        out = InstanceTypes()
        for it in its:
            patched = it
            for o in overlays:
                reqs = Requirements.from_node_selector_requirements(o.requirements)
                if not it.requirements.is_compatible(reqs):
                    continue
                patched = copy.deepcopy(patched) if patched is it else patched
                if o.capacity:
                    patched.capacity = res.merge(patched.capacity, o.capacity)
                    # invalidate the memoized allocatable
                    patched._allocatable = None
                else:
                    for off in patched.offerings:
                        off.price = o.adjusted_price(off.price)
                # highest-weight overlay wins per field; later (lower-weight)
                # overlays of the same kind don't stack (controller.go:69
                # ordered evaluation + conflict rules)
                break
            out.append(patched)
        return out
