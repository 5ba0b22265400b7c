"""Rule guarding the metric exposition surface: the reference's rule over
the port's `metrics.REGISTRY`.

- metric-naming: every `metrics.REGISTRY.counter/gauge/histogram(...)`
  registration site must use a LITERAL name with the `karpenter_` prefix
  and Prometheus-legal characters, a literal non-empty help string, and a
  name no other registration site in the run already claimed.
  Registry._register silently returns the EXISTING metric on a name
  collision — two modules registering the same name with different label
  sets would ship one of them broken, with no error anywhere. The literal
  requirement is load-bearing too: this rule reads names from source, so
  a computed name would be invisible to every mechanical check.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from karpenter_tpu_torch.analysis.engine import FileContext, Finding, Rule

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_REGISTER_METHODS = frozenset({"counter", "gauge", "histogram"})


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class MetricNamingRule(Rule):
    id = "metric-naming"
    summary = (
        "REGISTRY metric registrations need a literal karpenter_-prefixed "
        "unique name and a non-empty help string"
    )
    targets = ("karpenter_tpu_torch/**/*.py",)

    def __init__(self) -> None:
        # name -> (path, line) of the first registration seen in THIS
        # analyzer run; the engine runs one rule instance over every file
        # (sorted order), so cross-file duplicates surface on the later
        # site. A --changed-only run only sees within-file duplicates —
        # the full-tree pytest gate covers the rest.
        self._seen: dict[str, tuple[str, int]] = {}

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (
                isinstance(f, ast.Attribute) and f.attr in _REGISTER_METHODS
            ):
                continue
            recv = f.value
            # registration sites go through the module-level REGISTRY
            # (bare or `metrics.REGISTRY`); ad-hoc Registry() instances in
            # tests/fixtures are their own namespace and stay out of scope
            if not (
                (isinstance(recv, ast.Name) and recv.id == "REGISTRY")
                or (isinstance(recv, ast.Attribute) and recv.attr == "REGISTRY")
            ):
                continue
            name_node = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"), None
            )
            help_node = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "help"), None
            )
            name = _literal_str(name_node)
            if name is None:
                out.append(
                    ctx.finding(
                        self.id,
                        node,
                        f"metric name passed to REGISTRY.{f.attr}() must be "
                        "a string literal (the catalog drift test and this "
                        "rule read names from source)",
                    )
                )
            else:
                if not name.startswith("karpenter_"):
                    out.append(
                        ctx.finding(
                            self.id,
                            node,
                            f"metric {name!r} lacks the karpenter_ namespace "
                            "prefix (reference pkg/metrics/metrics.go:32)",
                        )
                    )
                elif not _NAME_RE.match(name):
                    out.append(
                        ctx.finding(
                            self.id,
                            node,
                            f"metric {name!r} contains characters outside "
                            "[a-zA-Z0-9_:]",
                        )
                    )
                prev = self._seen.get(name)
                here = (ctx.relpath, node.lineno)
                if prev is not None and prev != here:
                    out.append(
                        ctx.finding(
                            self.id,
                            node,
                            f"metric {name!r} already registered at "
                            f"{prev[0]}:{prev[1]} — Registry._register "
                            "silently returns the existing metric on a "
                            "name collision",
                        )
                    )
                else:
                    self._seen[name] = here
            help_text = _literal_str(help_node)
            # missing, computed, or blank all fail: help must be a LITERAL
            # non-empty string, same source-visibility contract as names
            if help_text is None or not help_text.strip():
                out.append(
                    ctx.finding(
                        self.id,
                        node,
                        f"metric registration via REGISTRY.{f.attr}() needs "
                        "a literal non-empty help string (# HELP is the "
                        "operator's only in-band documentation)",
                    )
                )
        return out


RULES = (MetricNamingRule,)
