"""NodePool validation: only the requirement validator the provisioner's
pod validation calls (`validate_requirement`, nodeclaim_validation.go:115)
and the name and value checks it uses, copied from the JAX package's
`controllers/nodepool_aux.py`. The NodePool controllers themselves come
with the slice of the Operator's controllers.
"""

from __future__ import annotations

import re
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known

_NAME_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9._-]*[A-Za-z0-9])?$")
_DNS1123_RE = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9-]*[a-z0-9])?)*$")


def _qualified_name_err(key: str) -> Optional[str]:
    """k8s.io/apimachinery validation.IsQualifiedName: [prefix/]name with a
    DNS-1123-subdomain prefix <= 253 chars and a name part <= 63."""
    if not key:
        return "name part must be non-empty"
    parts = key.split("/")
    if len(parts) > 2:
        return "a qualified name must consist of alphanumeric characters"
    if len(parts) == 2:
        prefix, name = parts
        if not prefix:
            return "prefix part must be non-empty"
        if len(prefix) > 253:
            return "prefix part must be no more than 253 characters"
        if not _DNS1123_RE.match(prefix):
            return "prefix part must be a DNS-1123 subdomain"
    else:
        name = parts[0]
    if not name:
        return "name part must be non-empty"
    if len(name) > 63:
        return "name part must be no more than 63 characters"
    if not _NAME_RE.match(name):
        return (
            "name part must consist of alphanumeric characters, '-', '_' "
            "or '.', and must start and end with an alphanumeric character"
        )
    return None


def _label_value_err(value: str) -> Optional[str]:
    if value == "":
        return None
    if len(value) > 63:
        return "must be no more than 63 characters"
    if not _NAME_RE.match(value):
        return (
            "a valid label value must be an empty string or consist of "
            "alphanumeric characters, '-', '_' or '.'"
        )
    return None


_SUPPORTED_OPS = frozenset(
    {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
)


def validate_requirement(r) -> Optional[str]:
    """nodeclaim_validation.go:115 ValidateRequirement, shared by the
    NodePool template validator and the provisioner's per-pod selector
    validation (provisioner.go:573 validateNodeSelectorTerm): normalized
    key, supported operator, restricted-label check, qualified name, label
    values, In non-empty, minValues bounds, Gt/Lt integer shape, and
    well-known value sets."""
    key = well_known.NORMALIZED_LABELS.get(r.key, r.key)
    err = _qualified_name_err(key)
    if err:
        return f"key {key} is not a qualified name, {err}"
    err = well_known.is_restricted_label(key)
    if err:
        return err
    op = str(getattr(r.operator, "value", r.operator))
    if op not in _SUPPORTED_OPS:
        return f"key {key} has an unsupported operator {op}"
    for v in r.values:
        err = _label_value_err(v)
        if err:
            return f"invalid value {v} for key {key}, {err}"
    if op == "In" and not r.values:
        return f"key {key} with operator 'In' must have a value defined"
    if op in ("Gt", "Lt"):
        ok = len(r.values) == 1
        if ok:
            try:
                ok = int(r.values[0]) >= 0
            except ValueError:
                ok = False
        if not ok:
            return (
                f"key {key} with operator {op!r} must have a single "
                "positive integer value"
            )
    mv = getattr(r, "min_values", None)
    if mv is not None:
        if mv < 1:
            return "minValues must be at least 1"
        if mv > 50:
            return "minValues must be no more than 50"
        # raw length, no dedup (nodeclaim_validation.go:142 compares
        # len(Values) directly)
        if op == "In" and len(r.values) < mv:
            return (
                "requirements with 'minValues' must have at least that many "
                "values specified in the 'values' field"
            )
    # validateWellKnownValues (nodeclaim_validation.go:164-191): an In set
    # for a key with a known value universe must keep at least one known
    # value — and at least minValues of them when minValues is set
    known = well_known.WELL_KNOWN_VALUES_FOR_REQUIREMENTS.get(key)
    if known is not None and op == "In" and r.values:
        valid = [v for v in r.values if v in known]
        if not valid:
            return (
                f"no valid values found in {r.values} for {key}, expected "
                f"one of: {sorted(known)}"
            )
        if mv is not None and len(valid) < mv:
            return (
                f"only {len(valid)} valid values found in {r.values} for "
                f"{key}, expected at least {mv}"
            )
    return None
