"""Rules guarding documentation and test metadata: the reference's rules
over the port.

- citation-check: docstrings claiming parity cite `path:line` — the
  port's cite the JAX package's lines (`karpenter_tpu/...py:N`, the
  kernel a wrapper replaces) and the Go reference's. `.go` citations
  resolve under the Go reference's checkout (`Config.reference_root`;
  unverifiable and skipped without one), in-repo `.py`/`.cc` citations
  under the repo root; a cited line past the end of the file means the
  citation rotted.
- pytest-markers (over tests/test_torch_*.py): a typo'd marker silently
  selects nothing under `-m`;
  with `--strict-markers` registration is enforced at collection, and
  this rule catches the same drift at lint time (including markers built
  in string expressions strict collection never sees).
"""

from __future__ import annotations

import ast
import os
import re

from karpenter_tpu_torch.analysis.engine import FileContext, Finding, Rule

_CITATION_RE = re.compile(
    r"(?<![\w/])(/?(?:[\w.-]+/)*[\w.-]*\.(go|py|cc)):(\d+)(?:-(\d+))?"
)


class CitationCheckRule(Rule):
    id = "citation-check"
    summary = (
        "docstring path:line citations must resolve (reference tree for "
        ".go, repo tree for .py/.cc) and stay within the cited file"
    )
    targets = ("karpenter_tpu_torch/**/*.py",)

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(
                node,
                (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
            ):
                continue
            doc = ast.get_docstring(node, clean=False)
            if not doc:
                continue
            line0 = 1 if isinstance(node, ast.Module) else node.body[0].lineno
            for m in _CITATION_RE.finditer(doc):
                msg = self._resolve(ctx, m)
                if msg:
                    out.append(ctx.finding(self.id, line0, msg))
        return out

    def _resolve(self, ctx: FileContext, m: re.Match) -> str:
        cited, ext, start = m.group(1), m.group(2), int(m.group(3))
        end = int(m.group(4)) if m.group(4) else start
        ref_root = ctx.config.reference_root
        in_ref = bool(ref_root) and cited.startswith(ref_root.rstrip("/") + "/")
        if ext == "go" or in_ref:
            if not ref_root or not os.path.isdir(ref_root):
                return ""  # reference checkout absent: unverifiable here
            root, rel = ref_root, cited
            if in_ref:
                rel = cited[len(ref_root.rstrip("/")) + 1 :]
            matches = self._suffix_matches(root, rel)
        else:
            matches = self._suffix_matches(ctx.config.repo_root, cited)
        token = m.group(0)
        if not matches:
            return (
                f"citation `{token}` does not resolve to any file "
                "(suffix match) — the parity claim is unverifiable"
            )
        for path in matches:
            try:
                with open(path, "rb") as f:
                    nlines = f.read().count(b"\n") + 1
            except OSError:
                continue
            if start <= nlines and end <= nlines:
                return ""
        return (
            f"citation `{token}` points past the end of "
            f"{os.path.basename(matches[0])} — the cited lines moved"
        )

    # one index per (root) per run; FileContext is per-file, so cache on
    # the config object
    def _suffix_matches(self, root: str, cited: str) -> list[str]:
        cache = getattr(self, "_index_cache", None)
        if cache is None:
            cache = self._index_cache = {}
        index = cache.get(root)
        if index is None:
            index = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [
                    d
                    for d in dirnames
                    if d not in (".git", "__pycache__", "node_modules")
                ]
                for fn in filenames:
                    if fn.endswith((".go", ".py", ".cc", ".h")):
                        index.append(os.path.join(dirpath, fn))
            cache[root] = index
        cited_norm = "/" + cited.lstrip("/")
        return [p for p in index if p.replace(os.sep, "/").endswith(cited_norm)]


# markers pytest itself defines; everything else must be registered in
# pyproject [tool.pytest.ini_options] markers
_BUILTIN_MARKERS = frozenset(
    {
        "parametrize",
        "skip",
        "skipif",
        "xfail",
        "usefixtures",
        "filterwarnings",
        "tryfirst",
        "trylast",
    }
)


class PytestMarkersRule(Rule):
    id = "pytest-markers"
    summary = (
        "pytest.mark.<name> must be registered in pyproject.toml (a typo'd "
        "marker silently deselects the test under -m)"
    )
    targets = ("tests/*.py", "tests/**/*.py")

    def check(self, ctx: FileContext) -> list[Finding]:
        registered = ctx.config.markers | _BUILTIN_MARKERS
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Attribute):
                continue
            v = node.value
            if (
                isinstance(v, ast.Attribute)
                and v.attr == "mark"
                and isinstance(v.value, ast.Name)
                and v.value.id == "pytest"
            ):
                if node.attr not in registered:
                    out.append(
                        ctx.finding(
                            self.id,
                            node,
                            f"marker `{node.attr}` is not registered in "
                            "pyproject.toml markers (typo, or register it "
                            "— --strict-markers fails collection on it)",
                        )
                    )
        return out


RULES = (CitationCheckRule, PytestMarkersRule)
