"""The constraint algebra: Requirement / Requirements.

This is the inner loop of the whole framework — every compatibility decision in
the scheduler reduces to set algebra over label-value constraints. Semantics
follow the reference exactly:

- Requirement: pkg/scheduling/requirement.go:36-231
  A (possibly complemented) set of label values with optional integer bounds
  (Gt/Lt) and a MinValues flexibility floor. `In` is a concrete set; `NotIn`,
  `Exists`, `Gt`, `Lt` are complements; `DoesNotExist` is the empty concrete set.
- Requirements: pkg/scheduling/requirements.go:36-268
  A key->Requirement map with auto-intersection on Add, `Exists` as the default
  for absent keys, and the asymmetric Compatible() rule: custom labels must be
  *defined* on the target, well-known labels may be undefined.

The TPU solver does not execute this Python code in its hot path — it encodes
the same semantics into bitmask tensors (karpenter_tpu.ops.encode) — but this
class is the source of truth, the oracle the tensors are tested against.
"""

from __future__ import annotations

import random
import sys

# Seeded module-level RNG so representative values for complement requirements
# (any_value on NotIn/Exists/Gt/Lt) are deterministic across identical runs —
# required for bit-identical oracle-vs-TPU comparisons.
_any_rng = random.Random(0x5EED)
from typing import Iterable, Iterator, Mapping, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    NodeSelectorRequirement,
    Operator,
    Pod,
)

_MAX_LEN = sys.maxsize


def _parse_int(value: str) -> Optional[int]:
    try:
        return int(value)
    except ValueError:
        return None


def _within_bounds(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    """reference requirement.go:311 withinIntPtrs — non-integer values are
    invalid when bounds are set."""
    if greater_than is None and less_than is None:
        return True
    iv = _parse_int(value)
    if iv is None:
        return False
    if greater_than is not None and greater_than >= iv:
        return False
    if less_than is not None and less_than <= iv:
        return False
    return True


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


class Requirement:
    """An efficient representation of a NodeSelectorRequirement
    (reference requirement.go:36)."""

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        operator: Operator | str,
        values: Iterable[str] = (),
        min_values: Optional[int] = None,
    ):
        key = well_known.NORMALIZED_LABELS.get(key, key)
        operator = Operator(operator)
        self.key = key
        self.min_values = min_values
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        values = list(values)
        if operator == Operator.IN:
            self.complement = False
            self.values: set[str] = set(values)
        elif operator == Operator.DOES_NOT_EXIST:
            self.complement = False
            self.values = set()
        else:
            self.complement = True
            self.values = set()
            if operator == Operator.NOT_IN:
                self.values.update(values)
            elif operator == Operator.GT:
                self.greater_than = int(values[0])
            elif operator == Operator.LT:
                self.less_than = int(values[0])

    @classmethod
    def _raw(
        cls,
        key: str,
        complement: bool,
        values: set[str],
        greater_than: Optional[int] = None,
        less_than: Optional[int] = None,
        min_values: Optional[int] = None,
    ) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.greater_than = greater_than
        r.less_than = less_than
        r.min_values = min_values
        return r

    @classmethod
    def from_node_selector_requirement(cls, nsr: NodeSelectorRequirement) -> "Requirement":
        return cls(nsr.key, nsr.operator, nsr.values, nsr.min_values)

    # -- algebra ---------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """reference requirement.go:158 Intersection."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        min_values = _max_opt(self.min_values, other.min_values)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, Operator.DOES_NOT_EXIST, min_values=min_values)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within_bounds(v, greater_than, less_than)}
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, complement, values, greater_than, less_than, min_values)

    def has_intersection(self, other: "Requirement") -> bool:
        """Zero-allocation intersection test (reference requirement.go:197)."""
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return False
        if self.complement and other.complement:
            return True
        if self.complement and not other.complement:
            return any(
                v not in self.values and _within_bounds(v, greater_than, less_than)
                for v in other.values
            )
        if not self.complement and other.complement:
            return any(
                v not in other.values and _within_bounds(v, greater_than, less_than)
                for v in self.values
            )
        # both In: a shared value within the bounds; walk the smaller set
        small, large = (
            (self.values, other.values) if len(self.values) <= len(other.values) else (other.values, self.values)
        )
        return any(v in large and _within_bounds(v, greater_than, less_than) for v in small)

    def has(self, value: str) -> bool:
        """True if the requirement allows the value (requirement.go:252)."""
        if self.complement:
            return value not in self.values and _within_bounds(
                value, self.greater_than, self.less_than
            )
        return value in self.values and _within_bounds(value, self.greater_than, self.less_than)

    def any_value(self) -> str:
        """A representative allowed value (requirement.go:233 Any)."""
        op = self.operator()
        if op == Operator.IN:
            return min(self.values)  # deterministic, unlike the reference's map order
        if op in (Operator.NOT_IN, Operator.EXISTS):
            lo = 0 if self.greater_than is None else self.greater_than + 1
            hi = (1 << 63) if self.less_than is None else self.less_than
            if lo >= hi:
                return ""
            for _ in range(100):
                candidate = str(_any_rng.randrange(lo, hi))
                if candidate not in self.values:
                    return candidate
        return ""

    def operator(self) -> Operator:
        """requirement.go:267 Operator (Gt/Lt render as Exists-with-bounds)."""
        if self.complement:
            return Operator.NOT_IN if self.values else Operator.EXISTS
        return Operator.IN if self.values else Operator.DOES_NOT_EXIST

    def __len__(self) -> int:
        if self.complement:
            return _MAX_LEN - len(self.values)
        return len(self.values)

    def to_node_selector_requirement(self) -> NodeSelectorRequirement:
        """requirement.go:93 NodeSelectorRequirement."""
        if self.greater_than is not None:
            return NodeSelectorRequirement(
                self.key, Operator.GT, [str(self.greater_than)], self.min_values
            )
        if self.less_than is not None:
            return NodeSelectorRequirement(
                self.key, Operator.LT, [str(self.less_than)], self.min_values
            )
        return NodeSelectorRequirement(
            self.key, self.operator(), sorted(self.values), self.min_values
        )

    def copy(self) -> "Requirement":
        return Requirement._raw(
            self.key,
            self.complement,
            set(self.values),
            self.greater_than,
            self.less_than,
            self.min_values,
        )

    def __repr__(self) -> str:
        op = self.operator()
        if op in (Operator.EXISTS, Operator.DOES_NOT_EXIST):
            s = f"{self.key} {op.value}"
        else:
            values = sorted(self.values)
            if len(values) > 5:
                values = values[:5] + [f"and {len(values) - 5} others"]
            s = f"{self.key} {op.value} {values}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        if self.min_values is not None:
            s += f" minValues {self.min_values}"
        return s


# Sentinel option mirroring the reference's scheduling.AllowUndefinedWellKnownLabels
# (requirements.go:166): pass as `allow_undefined` to allow the (mutable) global
# well-known label set to be undefined on the target. Resolved identity-wise in
# compatible(), so late provider registrations into WELL_KNOWN_LABELS are seen.
ALLOW_UNDEFINED_WELL_KNOWN_LABELS = frozenset({"\x00allow-undefined-well-known-labels"})


class Requirements:
    """Key->Requirement map with intersection semantics
    (reference requirements.go:36)."""

    __slots__ = ("_reqs",)

    def __init__(self, requirements: Iterable[Requirement] = ()):
        self._reqs: dict[str, Requirement] = {}
        self.add(*requirements)

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_labels(cls, labels: Mapping[str, str]) -> "Requirements":
        return cls(Requirement(k, Operator.IN, [v]) for k, v in labels.items())

    @classmethod
    def from_node_selector_requirements(
        cls, nsrs: Iterable[NodeSelectorRequirement]
    ) -> "Requirements":
        return cls(Requirement.from_node_selector_requirement(n) for n in nsrs)

    @classmethod
    def from_pod(cls, pod: Pod) -> "Requirements":
        """NewPodRequirements: node selector + heaviest node-affinity preference
        + first required term (requirements.go:90)."""
        return cls._from_pod(pod, include_preferred=True)

    @classmethod
    def strict_from_pod(cls, pod: Pod) -> "Requirements":
        """NewStrictPodRequirements: required constraints only."""
        return cls._from_pod(pod, include_preferred=False)

    @classmethod
    def _from_pod(cls, pod: Pod, include_preferred: bool) -> "Requirements":
        requirements = cls.from_labels(pod.node_selector)
        affinity = pod.node_affinity
        if affinity is None:
            return requirements
        if include_preferred and affinity.preferred:
            heaviest = max(affinity.preferred, key=lambda t: t.weight)
            requirements.add(
                *(
                    Requirement.from_node_selector_requirement(e)
                    for e in heaviest.preference.match_expressions
                )
            )
        if affinity.required_terms:
            requirements.add(
                *(
                    Requirement.from_node_selector_requirement(e)
                    for e in affinity.required_terms[0].match_expressions
                )
            )
        return requirements

    # -- map behavior ----------------------------------------------------

    def add(self, *requirements: Requirement) -> None:
        """Add with auto-intersection on key collision (requirements.go:127)."""
        for requirement in requirements:
            existing = self._reqs.get(requirement.key)
            if existing is not None:
                requirement = requirement.intersection(existing)
            self._reqs[requirement.key] = requirement

    def get(self, key: str) -> Requirement:
        """Absent keys default to Exists (requirements.go:154)."""
        r = self._reqs.get(key)
        if r is None:
            return Requirement(key, Operator.EXISTS)
        return r

    def has(self, key: str) -> bool:
        return key in self._reqs

    def keys(self) -> set[str]:
        return set(self._reqs)

    def values(self) -> list[Requirement]:
        return list(self._reqs.values())

    def pop(self, key: str) -> None:
        self._reqs.pop(key, None)

    def __iter__(self) -> Iterator[str]:
        return iter(self._reqs)

    def __len__(self) -> int:
        return len(self._reqs)

    def __contains__(self, key: str) -> bool:
        return key in self._reqs

    def copy(self) -> "Requirements":
        c = Requirements.__new__(Requirements)
        c._reqs = {k: v.copy() for k, v in self._reqs.items()}
        return c

    # -- compatibility ---------------------------------------------------

    def compatible(
        self, requirements: "Requirements", allow_undefined: Optional[set[str]] = None
    ) -> Optional[str]:
        """Ensure the incoming requirements can loosely be met
        (requirements.go:175 Compatible). Returns an error string or None.

        Custom labels must be *defined* on self; labels in `allow_undefined`
        (usually the well-known set) may be undefined.
        """
        return self._undefined_error(requirements, allow_undefined) or self.intersects(requirements)

    def is_compatible(
        self, requirements: "Requirements", allow_undefined: Optional[set[str]] = None
    ) -> bool:
        """`compatible(...) is None`, without building the error text."""
        return self._undefined_error(requirements, allow_undefined) is None and next(
            self._conflicts(requirements), None
        ) is None

    def _undefined_error(self, requirements: "Requirements", allow_undefined: Optional[set[str]]) -> Optional[str]:
        """The first incoming custom label self does not define (and that
        does not merely exclude values), as compatible's error."""
        if allow_undefined is ALLOW_UNDEFINED_WELL_KNOWN_LABELS:
            allow_undefined = well_known.WELL_KNOWN_LABELS
        allow = allow_undefined or set()
        for key in requirements:
            if key in allow:
                continue
            op = requirements.get(key).operator()
            if self.has(key) or op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                continue
            return f'label "{key}" does not have known values'
        return None

    def intersects(self, requirements: "Requirements") -> Optional[str]:
        """Error if shared keys have no overlapping values (requirements.go:248).
        Undefined keys are allowed. NotIn/DoesNotExist-vs-NotIn/DoesNotExist
        disagreements are tolerated."""
        errs = [f"key {key}, {incoming!r} not in {existing!r}" for key, existing, incoming in self._conflicts(requirements)]
        return "; ".join(errs) if errs else None

    def _conflicts(self, requirements: "Requirements"):
        """(key, existing, incoming) of each shared key whose values do not
        overlap, in intersects' order (lazily: a caller that needs only
        whether there is one stops at the first)."""
        small, large = (
            (self, requirements) if len(self._reqs) <= len(requirements._reqs) else (requirements, self)
        )
        for key in small._reqs:
            if key not in large._reqs:
                continue
            existing = self.get(key)
            incoming = requirements.get(key)
            if not existing.has_intersection(incoming):
                in_op = incoming.operator()
                if in_op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                    ex_op = existing.operator()
                    if ex_op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                        continue
                yield key, existing, incoming

    def labels(self) -> dict[str, str]:
        """Representative node labels (requirements.go:270 Labels)."""
        out = {}
        for key, requirement in self._reqs.items():
            if not well_known.is_restricted_node_label(key):
                value = requirement.any_value()
                if value:
                    out[key] = value
        return out

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._reqs.values())

    def to_node_selector_requirements(self) -> list[NodeSelectorRequirement]:
        return [r.to_node_selector_requirement() for r in self._reqs.values()]

    def __repr__(self) -> str:
        parts = sorted(
            repr(r)
            for r in self._reqs.values()
            if r.key not in well_known.RESTRICTED_LABELS
        )
        return ", ".join(parts)
