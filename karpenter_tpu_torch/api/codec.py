"""JSON codec for the API objects: the wire form of a scheduling problem.

The solver service boundary (karpenter_tpu.solver.service) ships problems as
one JSON header plus flat array blobs; this module is the header side —
dataclass <-> jsonable dict, with enums by value and a class registry for
round-tripping. The reference's equivalent is the protobuf schema a
cgo->gRPC sidecar would use (SURVEY.md §7 M5)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from karpenter_tpu_torch.api import objects as api
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    InstanceTypes,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling import Requirement, Requirements

_REGISTRY: dict[str, type] = {}


def _register(*classes):
    for c in classes:
        _REGISTRY[c.__name__] = c


_register(
    api.ObjectMeta,
    api.NodeSelectorRequirement,
    api.LabelSelectorRequirement,
    api.LabelSelector,
    api.Taint,
    api.Toleration,
    api.NodeSelectorTerm,
    api.PreferredSchedulingTerm,
    api.NodeAffinity,
    api.PodAffinityTerm,
    api.WeightedPodAffinityTerm,
    api.TopologySpreadConstraint,
    api.Container,
    api.Pod,
    api.Node,
    api.Budget,
    api.Disruption,
    api.NodeClaimTemplateSpec,
    api.NodePool,
    api.NodeClaimStatus,
    api.NodeClaim,
    api.PodDisruptionBudget,
    api.StorageClass,
    api.PersistentVolumeClaim,
    InstanceTypeOverhead,
)

_ENUMS = {
    e.__name__: e
    for e in (
        api.Operator,
        api.TaintEffect,
        api.WhenUnsatisfiable,
        api.NodeInclusionPolicy,
        api.PodPhase,
        api.ConsolidationPolicy,
    )
}

# Every api enum subclasses str, so to_jsonable's primitive fast path
# serializes them as their BARE VALUE (compact, and exactly what the C++
# client emits — the `__enum__` envelope below only matters for plain
# Enums). A bare value decodes as `str`, which compares EQUAL to its
# str-enum member — so every requirement/taint/phase comparison works —
# but `.value` accesses crash (`taint.effect.value` in an error-message
# path was the differential fuzzer's find, corpus pin seed8505). Coerce
# the known enum-typed dataclass fields back to members at decode; the
# wire bytes are unchanged, so pre-fix senders round-trip identically.
_ENUM_FIELDS: dict[str, dict[str, type]] = {
    "NodeSelectorRequirement": {"operator": api.Operator},
    "LabelSelectorRequirement": {"operator": api.Operator},
    "Taint": {"effect": api.TaintEffect},
    "Toleration": {"effect": api.TaintEffect},
    "TopologySpreadConstraint": {
        "when_unsatisfiable": api.WhenUnsatisfiable,
        "node_affinity_policy": api.NodeInclusionPolicy,
        "node_taints_policy": api.NodeInclusionPolicy,
    },
    "Pod": {"phase": api.PodPhase},
    "Disruption": {"consolidation_policy": api.ConsolidationPolicy},
}


def to_jsonable(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return {"__enum__": type(obj).__name__, "value": obj.value}
    if isinstance(obj, Requirements):
        return {
            "__type__": "Requirements",
            "requirements": [
                to_jsonable(r) for r in obj.to_node_selector_requirements()
            ],
        }
    if isinstance(obj, Requirement):
        return to_jsonable(_requirement_to_nsr(obj))
    if isinstance(obj, InstanceType):
        return {
            "__type__": "InstanceType",
            "name": obj.name,
            "requirements": to_jsonable(obj.requirements),
            "offerings": [to_jsonable(o) for o in obj.offerings],
            "capacity": dict(obj.capacity),
            "overhead": to_jsonable(obj.overhead),
        }
    if isinstance(obj, Offering):
        return {
            "__type__": "Offering",
            "requirements": to_jsonable(obj.requirements),
            "price": obj.price,
            "available": obj.available,
            "reservation_capacity": obj.reservation_capacity,
        }
    if dataclasses.is_dataclass(obj):
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):
                continue
            out[f.name] = to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def from_jsonable(data: Any) -> Any:
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [from_jsonable(v) for v in data]
    if isinstance(data, dict):
        if "__enum__" in data:
            return _ENUMS[data["__enum__"]](data["value"])
        tname = data.get("__type__")
        if tname == "Requirements":
            reqs = Requirements()
            nsrs = [from_jsonable(r) for r in data["requirements"]]
            reqs.add(*Requirements.from_node_selector_requirements(nsrs).values())
            return reqs
        if tname == "InstanceType":
            return InstanceType(
                name=data["name"],
                requirements=from_jsonable(data["requirements"]),
                offerings=Offerings(
                    from_jsonable(o) for o in data["offerings"]
                ),
                capacity={k: int(v) for k, v in data["capacity"].items()},
                overhead=from_jsonable(data["overhead"]),
            )
        if tname == "Offering":
            return Offering(
                requirements=from_jsonable(data["requirements"]),
                price=data["price"],
                available=data["available"],
                reservation_capacity=data["reservation_capacity"],
            )
        if tname is not None:
            cls = _REGISTRY[tname]
            kwargs = {
                k: from_jsonable(v)
                for k, v in data.items()
                if k != "__type__"
            }
            for k, enum_cls in _ENUM_FIELDS.get(tname, {}).items():
                v = kwargs.get(k)
                if isinstance(v, str) and not isinstance(v, enum.Enum):
                    kwargs[k] = enum_cls(v)
            return cls(**kwargs)
        return {k: from_jsonable(v) for k, v in data.items()}
    raise TypeError(f"cannot deserialize {type(data).__name__}")


def _requirement_to_nsr(r: Requirement) -> api.NodeSelectorRequirement:
    nsrs = Requirements([r]).to_node_selector_requirements()
    return nsrs[0]
