"""Exact Kubernetes resource-quantity arithmetic.

The reference (karpenter-core) uses k8s.io/apimachinery's resource.Quantity, an
exact decimal type. We represent every quantity as an integer count of
*milli-units* (Python ints are arbitrary precision, so arithmetic is exact):

    parse("100m")  -> 100          (0.1 cores  = 100 milli)
    parse("2")     -> 2000         (2 cores    = 2000 milli)
    parse("1Gi")   -> 1073741824000  (bytes x 1000)

Milli-units are the finest granularity Kubernetes supports for requests, so the
representation is lossless for every valid quantity. Reference semantics:
pkg/utils/resources/resources.go (Cmp/Fits/Merge/Subtract).
"""

from __future__ import annotations

import math
import re
from fractions import Fraction

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}

_QTY_RE = re.compile(r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)(?:[eE](?P<exp>[+-]?\d+))?(?P<suffix>m|Ki|Mi|Gi|Ti|Pi|Ei|k|M|G|T|P|E)?$")


def parse(value: str | int | float) -> int:
    """Parse a Kubernetes quantity string into integer milli-units.

    Non-integral milli amounts round up (k8s canonicalizes by rounding up, so a
    request can never be under-counted).
    """
    if isinstance(value, int):
        return value * 1000
    if isinstance(value, float):
        # Fraction(str(...)) keeps the decimal the caller wrote; Fraction(float)
        # would capture the binary over-approximation (0.1 -> 101 milli).
        return math.ceil(Fraction(str(value)) * 1000)
    m = _QTY_RE.match(value.strip())
    if not m:
        raise ValueError(f"cannot parse quantity {value!r}")
    num = Fraction(m.group("num"))
    if m.group("exp"):
        num *= Fraction(10) ** int(m.group("exp"))
    suffix = m.group("suffix")
    if suffix == "m":
        scaled = num  # already milli
    elif suffix in _BINARY:
        scaled = num * _BINARY[suffix] * 1000
    elif suffix in _DECIMAL:
        scaled = num * _DECIMAL[suffix] * 1000
    else:
        scaled = num * 1000
    if m.group("sign") == "-":
        scaled = -scaled
    return math.ceil(scaled)


def format_milli(millis: int) -> str:
    """Human-readable rendering of a milli-quantity (for logs/errors)."""
    if millis == 0:
        return "0"
    neg = "-" if millis < 0 else ""
    millis = abs(millis)
    if millis % 1000 != 0:
        return f"{neg}{millis}m"
    units = millis // 1000
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        base = _BINARY[suffix]
        if units % base == 0 and units >= base:
            return f"{neg}{units // base}{suffix}"
    for suffix in ("E", "P", "T", "G", "M", "k"):
        base = _DECIMAL[suffix]
        if units % base == 0 and units >= base:
            return f"{neg}{units // base}{suffix}"
    return f"{neg}{units}"
