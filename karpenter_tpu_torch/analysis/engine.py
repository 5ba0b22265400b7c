"""graftlint engine for the port: rule registry, suppression, baseline,
and the runner.

A copy of the reference's `analysis/engine.py`, aimed at the port's own
tree: `karpenter_tpu_torch/`, `tests/test_torch_*.py`, `chip_smoke.py`
and `tools/*_phase.py`. Rule ids, finding and report shapes, the
suppression syntax and the baseline format are the reference's, so a
finding in one package maps onto the other. Pure stdlib `ast`: importing
this package never pulls in torch, numpy or JAX.

Vocabulary:

- A *rule* inspects one parsed file (`FileContext`) and returns findings.
  Rules declare path targets; the engine only hands them files they apply
  to. Rule ids are kebab-case (`shared-comparator`).
- A *suppression* is a source comment `# graftlint: disable=<rule>[,<rule>]`.
  On a code line it silences findings on that line; on its own line it
  silences the next code line; on a `def`/`class` line it silences the
  whole body. `# graftlint: disable-file=<rule>` anywhere silences the
  file. `all` matches every rule.
- The *baseline* (torch_graftlint.baseline.json at the repo root)
  grandfathers intentional findings. Entries match on (rule, path,
  stripped source text) so they survive line drift; every entry carries a
  one-line justification and stale entries are reported so the file
  cannot rot.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import os
import re
from typing import Iterable, Optional

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-file)=([\w-]+(?:\s*,\s*[\w-]+)*)"
)


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    text: str  # stripped source line — the baseline identity

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.text)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# the tiers' baselines, at the repo root (the reference's graftlint.*
# files stay the JAX package's own)
DEFAULT_BASELINE = "torch_graftlint.baseline.json"
RACE_DEFAULT_BASELINE = "torch_graftlint.race.baseline.json"
PROTO_DEFAULT_BASELINE = "torch_graftlint.proto.baseline.json"

@dataclasses.dataclass
class Config:
    """Per-run settings rules consult through `ctx.config`."""

    repo_root: str
    # a checkout of the Go reference, where `.go` citations resolve
    # (`--reference-root`); without one they are unverifiable and skipped
    reference_root: str = ""
    # pytest markers registered in pyproject.toml (pytest-markers rule)
    markers: frozenset[str] = frozenset()

    @classmethod
    def for_repo(cls, repo_root: str, reference_root: Optional[str] = None) -> "Config":
        return cls(
            repo_root=repo_root,
            reference_root=reference_root or "",
            markers=load_registered_markers(
                os.path.join(repo_root, "pyproject.toml")
            ),
        )


def load_registered_markers(pyproject_path: str) -> frozenset[str]:
    """Marker names from [tool.pytest.ini_options] markers. Regex, not
    tomllib — the floor interpreter is 3.10 (pyproject requires-python)."""
    try:
        with open(pyproject_path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return frozenset()
    m = re.search(r"markers\s*=\s*\[(.*?)\]", text, re.DOTALL)
    if not m:
        return frozenset()
    return frozenset(
        re.findall(r"\"([A-Za-z_]\w*)", m.group(1))
    )


class FileContext:
    """One parsed source file plus the lookups rules need."""

    def __init__(self, path: str, relpath: str, source: str, config: Config):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.config = config
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._line_suppress: dict[int, set[str]] = {}
        self._file_suppress: set[str] = set()
        self._span_suppress: list[tuple[int, int, set[str]]] = []
        self._parse_suppressions()

    # -- construction helpers ------------------------------------------------

    def _parse_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",")}
            if m.group(1) == "disable-file":
                self._file_suppress |= rules
                continue
            target = i
            if line.lstrip().startswith("#"):
                # standalone comment shields the next CODE line — skip
                # blank lines and further comments in between
                target = i + 1
                while target <= len(self.lines):
                    nxt = self.lines[target - 1].strip()
                    if nxt and not nxt.startswith("#"):
                        break
                    target += 1
            self._line_suppress.setdefault(target, set()).update(rules)
        # a disable on a def/class line — or on one of its decorator
        # lines, where a standalone comment above a decorated function
        # lands — shields the whole body
        for node in ast.walk(self.tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                head_lines = [d.lineno for d in node.decorator_list] + [
                    node.lineno
                ]
                rules = set()
                for ln in head_lines:
                    rules |= self._line_suppress.get(ln, set())
                if rules:
                    self._span_suppress.append(
                        (min(head_lines), node.end_lineno or node.lineno, rules)
                    )

    # -- rule-facing API -----------------------------------------------------

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.source, node) or ""

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = (
            node_or_line
            if isinstance(node_or_line, int)
            else getattr(node_or_line, "lineno", 1)
        )
        return Finding(
            rule=rule,
            path=self.relpath,
            line=line,
            message=message,
            text=self.line_text(line),
        )

    def suppressed(self, finding: Finding) -> bool:
        for rules in (
            self._file_suppress,
            self._line_suppress.get(finding.line, ()),
        ):
            if finding.rule in rules or "all" in rules:
                return True
        for lo, hi, rules in self._span_suppress:
            if lo <= finding.line <= hi and (
                finding.rule in rules or "all" in rules
            ):
                return True
        return False


class Rule:
    """Base rule. Subclasses set `id`, `summary`, `targets` (fnmatch
    patterns over the repo-relative path) and implement `check`."""

    id: str = ""
    summary: str = ""
    targets: tuple[str, ...] = ("**/*.py",)

    def applies_to(self, relpath: str) -> bool:
        relpath = relpath.replace(os.sep, "/")
        # fnmatch has no recursive `**`: `dir/**/*.py` would demand an
        # intermediate directory and silently skip dir's direct children,
        # so each pattern also matches with `**/` collapsed away
        return any(
            fnmatch.fnmatch(relpath, pat)
            or ("**/" in pat and fnmatch.fnmatch(relpath, pat.replace("**/", "")))
            for pat in self.targets
        )

    def check(self, ctx: FileContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def run(self, ctx: FileContext) -> list[Finding]:
        out, seen = [], set()
        for f in self.check(ctx):
            # one finding per (line, rule, message): multiline expressions
            # can hit a pattern several times on the same source line, but
            # distinct messages (two rotted citations in one docstring)
            # must both surface
            k = (f.line, f.rule, f.message)
            if k in seen or self.suppressed_in(ctx, f):
                continue
            seen.add(k)
            out.append(f)
        return out

    @staticmethod
    def suppressed_in(ctx: FileContext, finding: Finding) -> bool:
        return ctx.suppressed(finding)


# ---------------------------------------------------------------------------
# shared AST helpers


def base_name(node: ast.AST) -> Optional[str]:
    """Root Name id of an attribute/subscript/call chain (jnp.any -> jnp)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def iter_functions(tree: ast.Module) -> Iterable[ast.FunctionDef]:
    """Top-level functions and methods (nested defs ride their parent's
    source segment — accumulation guards are per outermost function)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield sub


def ordering_import_names(tree: ast.Module) -> set[str]:
    """Names bound from karpenter_tpu_torch.solver.ordering (module aliases
    and imported functions) — the shared-comparator allowlist."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "karpenter_tpu_torch.solver.ordering" or mod.endswith(
                ".ordering"
            ):
                names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith(".ordering") or a.name == "ordering":
                    names.add((a.asname or a.name).split(".")[0])
    return names


# ---------------------------------------------------------------------------
# canonical serialization (sorted keys, two-space indent, trailing
# newline — a re-written file with unchanged content is byte-identical)


def canonical_json(data: dict) -> str:
    return (
        json.dumps(data, indent=2, sort_keys=True, ensure_ascii=False) + "\n"
    )


# ---------------------------------------------------------------------------
# baseline


class Baseline:
    """Grandfathered findings with per-entry justification. Matching is a
    multiset over (rule, path, text): N identical findings need N entries."""

    def __init__(self, entries: list[dict], path: Optional[str] = None):
        self.entries = entries
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([], path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(list(data.get("entries", [])), path)

    def unjustified(self) -> list[dict]:
        return [
            e
            for e in self.entries
            if not str(e.get("justification", "")).strip()
            or str(e.get("justification", "")).startswith("TODO")
        ]

    def apply(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[dict]]:
        """Returns (unbaselined findings, stale entries)."""
        pool: dict[tuple, list[dict]] = {}
        for e in self.entries:
            k = (e.get("rule"), e.get("path"), e.get("text"))
            pool.setdefault(k, []).append(e)
        fresh = []
        for f in findings:
            bucket = pool.get(f.key())
            if bucket:
                bucket.pop()
            else:
                fresh.append(f)
        stale = [e for bucket in pool.values() for e in bucket]
        return fresh, stale

    @staticmethod
    def render_entries(findings: list[Finding]) -> dict:
        return {
            "entries": [
                {
                    "rule": f.rule,
                    "path": f.path,
                    "text": f.text,
                    "justification": "TODO: justify or fix",
                }
                for f in findings
            ]
        }

    def merge_justifications(self, data: dict) -> int:
        """Carry hand-written justifications from this baseline into a
        freshly rendered `data` (render_entries output): entries that
        still match keep their text, only genuinely new findings keep the
        TODO placeholder. Returns the number of new entries. Shared by
        every tier's `--write-baseline`."""
        keep: dict[tuple, list[str]] = {}
        for e in self.entries:
            k = (e.get("rule"), e.get("path"), e.get("text"))
            keep.setdefault(k, []).append(str(e.get("justification", "")))
        fresh = 0
        for entry in data["entries"]:
            k = (entry["rule"], entry["path"], entry["text"])
            bucket = keep.get(k)
            if bucket:
                entry["justification"] = bucket.pop(0)
            else:
                fresh += 1
        return fresh


# ---------------------------------------------------------------------------
# runner


def all_rules() -> list[Rule]:
    from karpenter_tpu_torch.analysis import (
        rules_data,
        rules_docs,
        rules_kernel,
        rules_metrics,
        rules_threads,
        rules_wire,
    )

    rules: list[Rule] = []
    for mod in (rules_kernel, rules_data, rules_threads, rules_docs,
                rules_metrics, rules_wire):
        rules.extend(r() for r in mod.RULES)
    return rules


# Rules switched off for tests/ (the reference's profiles): test helpers
# carry no reference-parity docstrings and no card path, but their lock
# discipline and marker spelling still matter.
TEST_RELAXED_OFF = frozenset({"citation-check", "kernel-purity"})


def profile_rule_ids(relpath: str, rules: list[Rule]) -> set[str]:
    ids = {r.id for r in rules}
    rel = relpath.replace(os.sep, "/")
    if rel.startswith("tests/") or "/tests/" in rel:
        ids -= TEST_RELAXED_OFF
    return ids


def default_roots(repo_root: str) -> list[str]:
    """The port's tree: the package, its tests, the chip script and the
    phase tools (never the JAX package)."""
    out = [os.path.join(repo_root, "karpenter_tpu_torch")]
    for sub, prefix, suffix in (("tests", "test_torch_", ".py"), ("tools", "", "_phase.py")):
        d = os.path.join(repo_root, sub)
        if os.path.isdir(d):
            out += [
                os.path.join(d, fn)
                for fn in sorted(os.listdir(d))
                if fn.startswith(prefix) and fn.endswith(suffix)
            ]
    smoke = os.path.join(repo_root, "chip_smoke.py")
    if os.path.isfile(smoke):
        out.append(smoke)
    return out


def discover_files(repo_root: str, paths: Optional[list[str]] = None) -> list[str]:
    """Python files to analyze: the port's tree, or explicit paths."""
    roots = paths or default_roots(repo_root)
    out = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [
                d for d in dirnames if d not in ("__pycache__", ".git")
            ]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def analyze_files(
    files: list[str],
    config: Config,
    rules: Optional[list[Rule]] = None,
    rule_ids: Optional[set[str]] = None,
) -> tuple[list[Finding], list[str]]:
    """Run rules over files. Returns (findings, errors) where errors are
    unparsable files (reported, never silently skipped)."""
    rules = rules if rules is not None else all_rules()
    if rule_ids is not None:
        rules = [r for r in rules if r.id in rule_ids]
    findings: list[Finding] = []
    errors: list[str] = []
    for path in files:
        rel = os.path.relpath(path, config.repo_root)
        active = profile_rule_ids(rel, rules)
        applicable = [
            r for r in rules if r.id in active and r.applies_to(rel)
        ]
        if not applicable:
            continue
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            ctx = FileContext(path, rel, source, config)
        except (OSError, SyntaxError) as e:
            errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        for rule in applicable:
            findings.extend(rule.run(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, errors


def run_analysis(
    repo_root: str,
    paths: Optional[list[str]] = None,
    baseline_path: Optional[str] = None,
    reference_root: Optional[str] = None,
    rule_ids: Optional[set[str]] = None,
) -> dict:
    """The full pipeline: discover, analyze, apply baseline. Returns
    {"findings": [...unbaselined...], "stale": [...], "errors": [...],
    "total": int} — the CLI and the pytest gate both consume this."""
    config = Config.for_repo(repo_root, reference_root)
    files = discover_files(repo_root, paths)
    findings, errors = analyze_files(files, config, rule_ids=rule_ids)
    baseline = Baseline.load(
        baseline_path
        if baseline_path is not None
        else os.path.join(repo_root, DEFAULT_BASELINE)
    )
    fresh, stale = baseline.apply(findings)
    return {
        "findings": fresh,
        "all_findings": findings,
        "stale": stale,
        "errors": errors,
        "unjustified": baseline.unjustified(),
        "total": len(findings),
    }
