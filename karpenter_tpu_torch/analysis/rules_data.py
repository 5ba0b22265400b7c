"""Rules guarding numeric exactness: the reference's rules over the port.

- dtype-overflow: int32 totals must never wrap — the consolidation
  sweep's exactness gates include host-side int64 overflow guards; any
  function in the sweep path that accumulates int32 totals (cumsum /
  axis-sum / matmul) must carry one, or a baseline entry that names the
  guard covering it.
- milli-units: resource quantities are integer milli-units everywhere
  (utils/resources.py); true division or float arithmetic touching a
  resource-named value either truncates wrongly or leaks floats into
  ResourceLists.
"""

from __future__ import annotations

import ast
import re

from karpenter_tpu_torch.analysis.engine import (
    FileContext,
    Finding,
    Rule,
    iter_functions,
)

# the delta-state consolidation sweeps (disruption/sweep.py and the
# removal-set generalization, disruption/setsweep.py)
SWEEP_MODULES = (
    "karpenter_tpu_torch/controllers/disruption/sweep.py",
    "karpenter_tpu_torch/controllers/disruption/setsweep.py",
)

_GUARD_BOUND_RE = re.compile(r"1\s*<<\s*3[01]|2\s*\*\*\s*3[01]|2147483647")


class DtypeOverflowRule(Rule):
    id = "dtype-overflow"
    summary = (
        "int32 accumulations in the sweep path need an explicit int64 "
        "host guard (int32 totals must never wrap)"
    )
    targets = SWEEP_MODULES

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        for fn in iter_functions(ctx.tree):
            seg = ctx.segment(fn)
            if "int32" not in seg:
                continue
            if not self._accumulates(fn):
                continue
            if "int64" in seg and _GUARD_BOUND_RE.search(seg):
                continue
            out.append(
                ctx.finding(
                    self.id,
                    fn,
                    f"{fn.name}() accumulates int32 totals (cumsum/sum/"
                    "matmul) without an int64 guard against a 2^31 bound; "
                    "verify the worst-case total host-side in int64 first",
                )
            )
        return out

    @staticmethod
    def _accumulates(fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
                return True
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("cumsum", "sum")
            ):
                return True
        return False


# identifiers that mark a value as a resource quantity (integer milli-units)
_RESOURCE_NAME_RE = re.compile(
    r"\b(requests?|capacity|limits|allocatable|avail\w*|overhead|millis?)\b"
)

_EXEMPT = (
    "karpenter_tpu_torch/utils/resources.py",  # the arithmetic home (the invariant)
    "karpenter_tpu_torch/utils/quantity.py",  # parses human floats INTO milli ints
)


class MilliUnitsRule(Rule):
    id = "milli-units"
    summary = (
        "no true division or float arithmetic on resource quantities "
        "outside utils/resources.py (integer milli-units everywhere)"
    )
    targets = ("karpenter_tpu_torch/**/*.py", "tests/**/*.py", "chip_smoke.py", "tools/*.py")

    def applies_to(self, relpath: str) -> bool:
        if relpath.replace("\\", "/") in _EXEMPT:
            return False
        return super().applies_to(relpath)

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        seen_lines: set[int] = set()  # one finding per offending line
        for node in ast.walk(ctx.tree):
            if getattr(node, "lineno", None) in seen_lines:
                continue
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                seg = ctx.segment(node)
                if _RESOURCE_NAME_RE.search(seg):
                    seen_lines.add(node.lineno)
                    out.append(
                        ctx.finding(
                            self.id,
                            node,
                            "true division on a resource-named quantity; "
                            "milli-unit arithmetic must stay integer "
                            "(// or utils/resources.py helpers)",
                        )
                    )
            elif isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Mult, ast.Add, ast.Sub)
            ):
                left_lit = self._float_literal(node.left)
                lit = left_lit if left_lit is not None else self._float_literal(
                    node.right
                )
                if lit is None:
                    continue
                other = node.right if left_lit is not None else node.left
                if _RESOURCE_NAME_RE.search(ctx.segment(other) or ""):
                    seen_lines.add(node.lineno)
                    out.append(
                        ctx.finding(
                            self.id,
                            node,
                            f"float literal {lit} combined with a resource-"
                            "named quantity; resource math is integer "
                            "milli-units",
                        )
                    )
        return out

    @staticmethod
    def _float_literal(node: ast.AST):
        # returns the literal (0.0 is a legitimate hit — callers must
        # compare against None, never truthiness)
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            return node.value
        if (
            isinstance(node, ast.UnaryOp)
            and isinstance(node.operand, ast.Constant)
            and isinstance(node.operand.value, float)
        ):
            return node.operand.value
        return None


RULES = (DtypeOverflowRule, MilliUnitsRule)
