"""Rules guarding the solver kernels' parity and the card path's syncs.

- shared-comparator: the oracle and the card path MUST sort with the same
  key or parity breaks — pod/solver ordering in the parity modules has to
  flow through solver/ordering.py, never an inline key. The reference's
  rule, over the port's copies of its parity modules.
- kernel-purity (the port's meaning): the card path makes no host sync
  outside the seams that torch_budgets.json counts. The card path is what
  runs between a solve's upload and its decode fetch: the kernels' seam
  wrappers (a function that calls `budgets.seam`, minus its CPU branch,
  where the plain version runs), the launch functions (a function that
  calls `budgets.launched`), the round loops of `CARD_LOOPS` (their
  `dispatch` spans where they have any, else the whole function), and the
  same-module functions those call. The plain versions (`*_plain`) are
  exempt: the plain reference path may sync. A host sync is `.item()`,
  `.tolist()`, `.cpu()`, `.numpy()`, `int/bool/float(<tensor>)`,
  `torch.nonzero`/`.nonzero()` or `.synchronize()` (torch.cuda, an Event
  or a Stream). A sync on the card path is allowed only where
  `COUNTED_SEAMS` names it, with the torch_budgets.json entry whose
  `host_syncs` counts it; a seam whose entry is gone is a finding. That
  the entry's window reaches the seam is checked on the card:
  `runtime.seam_issues` holds each seam to a sync-debug site inside its
  function in that entry's window (the budgets check, `--budgets` and
  chip_smoke.py's phase 14c).
- tracer-leak (the port's meaning): an `if`/`while` on the card path
  whose test reads a tensor (a `torch.*` call or a tensor reduction
  `.any()`/`.all()`/`.item()`/`.equal()`) is a host sync hidden in
  control flow.

The reference's rules read JAX traces (`jnp`/`lax` roots); a JAX program
has no host syncs between launches unless it calls back, so its meaning of
both rules is about the trace. The port launches from the host, so the
same two ids police the host code between launches instead.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Optional

from karpenter_tpu_torch.analysis.engine import (
    FileContext,
    Finding,
    Rule,
    base_name,
    ordering_import_names,
)

_PKG = "karpenter_tpu_torch/"

# modules whose decisions must stay bit-identical between oracle and kernel
PARITY_MODULES = (
    _PKG + "solver/oracle.py",
    _PKG + "solver/tpu_runs.py",
    _PKG + "solver/tpu.py",
    _PKG + "controllers/disruption/sweep.py",
)

# modules that hold a card path: the kernels' wrappers and the loops that
# dispatch them
KERNEL_MODULES = (
    _PKG + "solver/tpu_kernel.py",
    _PKG + "solver/tpu_runs.py",
    _PKG + "solver/tpu.py",
    _PKG + "solver/fleet.py",
    _PKG + "controllers/disruption/sweep.py",
    _PKG + "controllers/disruption/setsweep.py",
    _PKG + "ops/kernels.py",
)

# the round loops: functions that dispatch kernels and fetch their
# verdicts, by qualified name. Their `dispatch` spans are card path; a
# loop with no such span is card path whole.
CARD_LOOPS = {
    _PKG + "solver/tpu.py": ("TorchScheduler._solve_traced",),
    _PKG + "solver/fleet.py": ("FleetCoalescer._run_window", "_fetch"),
    _PKG + "controllers/disruption/sweep.py": ("_fast_prefix_feasibility", "_lane_scan_feasibility"),
    _PKG + "controllers/disruption/setsweep.py": ("SetSweepContext.evaluate",),
}

# the counted seams: (module, function) -> the syncs allowed there, the
# torch_budgets.json entry whose `host_syncs` counts them, and why they
# are there
COUNTED_SEAMS = {
    (_PKG + "solver/tpu.py", "TorchScheduler._solve_traced"): {
        "syncs": (".cpu()", ".numpy()", ".tolist()", "bool(got_over)"),
        "entry": "cuda:headline[runtime]",
        "why": "a dispatch's one fetch: kinds, slots and K3's counter block "
        "(the runs path) or K2's overflow flag (the scan path, cuda:solve[runtime])",
    },
    (_PKG + "solver/tpu_runs.py", "_launch_run_step"): {
        "syncs": ("int(next_seq)",),
        "entry": "cuda:headline[runtime]",
        "why": "K3's next event sequence number, read from the last "
        "dispatch's counter block into the new one",
    },
    (_PKG + "solver/tpu.py", "_odo_dispatch_dict"): {
        "syncs": ("int(odo.steps)", "int(odo.bulk_steps)", "int(odo.tier_steps)", ".tolist()", "int(v)"),
        "entry": "cuda:solve[runtime]",
        "why": "the scan path's odometer, read field by field after its "
        "dispatch (the runs path's comes back in the counter block)",
    },
    (_PKG + "solver/tpu_kernel.py", "type_tables"): {
        "syncs": ("torch.nonzero",),
        "entry": "cuda:headline[runtime]",
        "why": "the step kernels' type tables, derived once a Tables at its "
        "first launch (launch_type_tables) and cached",
    },
    (_PKG + "solver/fleet.py", "_fetch"): {
        "syncs": (".cpu()", ".numpy()"),
        "entry": "cuda:fleet[runtime]",
        "why": "a fleet window round's one fetch of every lane's verdicts and odometer",
    },
    (_PKG + "controllers/disruption/sweep.py", "_fast_prefix_feasibility"): {
        "syncs": (".cpu()", ".numpy()", "bool(v)", "int(steps)"),
        "entry": "cuda:sweep[runtime]",
        "why": "K6's verdicts and its step count, fetched once a sweep",
    },
    (_PKG + "controllers/disruption/sweep.py", "_lane_scan_feasibility"): {
        "syncs": (".cpu()", ".numpy()", ".tolist()"),
        "entry": "cuda:sweep_lanes[runtime]",
        "why": "K7's kinds, overflow flags, claim counts and step counts, "
        "packed on the card and fetched once a sweep (.tolist() reads the "
        "fetched host array)",
    },
    (_PKG + "controllers/disruption/setsweep.py", "SetSweepContext.evaluate"): {
        "syncs": (".cpu()", ".numpy()", "int(steps)"),
        "entry": "cuda:setsweep[runtime]",
        "why": "K8's verdicts and its step count, fetched once a batch",
    },
}

BUDGETS_MANIFEST = "torch_budgets.json"


class SharedComparatorRule(Rule):
    id = "shared-comparator"
    summary = (
        "sorts in parity modules must key through solver/ordering.py "
        "(the oracle and the card path must sort with the same key)"
    )
    targets = PARITY_MODULES

    def check(self, ctx: FileContext) -> list[Finding]:
        allowed = ordering_import_names(ctx.tree)
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            is_sorted = isinstance(node.func, ast.Name) and node.func.id == "sorted"
            is_sort = (
                isinstance(node.func, ast.Attribute) and node.func.attr == "sort"
            )
            if not (is_sorted or is_sort):
                continue
            key = next((k.value for k in node.keywords if k.arg == "key"), None)
            if key is None:
                continue  # keyless sorts order primitives, not pods
            if self._key_uses_ordering(key, allowed):
                continue
            out.append(
                ctx.finding(
                    self.id,
                    node,
                    "inline sort key in a parity module; route the "
                    "ordering through solver/ordering.py (ffd_sort_key / "
                    "ffd_order_cols) or baseline with a justification",
                )
            )
        return out

    @staticmethod
    def _key_uses_ordering(key: ast.AST, allowed: set[str]) -> bool:
        if isinstance(key, ast.Name) and key.id in allowed:
            return True
        for sub in ast.walk(key):
            if isinstance(sub, ast.Call):
                root = base_name(sub.func)
                fn = (
                    sub.func.attr
                    if isinstance(sub.func, ast.Attribute)
                    else getattr(sub.func, "id", None)
                )
                if root in allowed or fn in allowed:
                    return True
        return False


# ---------------------------------------------------------------------------
# the card path


def _functions(tree: ast.Module) -> dict[str, ast.AST]:
    """{qualified name: def} of module functions and class methods (one
    class level deep, as the modules are written)."""
    out: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _is_plain(qualname: str) -> bool:
    return qualname.rsplit(".", 1)[-1].endswith("_plain")


def _calls_attr(fn: ast.AST, root: str, attr: str) -> bool:
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == attr
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == root
        ):
            return True
    return False


def _is_cpu_test(test: ast.AST) -> bool:
    """`<...>.type == "cpu"`: the seam's branch to its plain version."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Compare) and any(
            isinstance(c, ast.Constant) and c.value == "cpu" for c in sub.comparators
        ):
            return True
    return False


def _span_name(item: ast.withitem) -> Optional[str]:
    """The span a `with <x>.span("name")` / `span_of(trace, "name")` opens."""
    call = item.context_expr
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    if name == "span" and call.args and isinstance(call.args[0], ast.Constant):
        return call.args[0].value
    if name == "span_of" and len(call.args) > 1 and isinstance(call.args[1], ast.Constant):
        return call.args[1].value
    return None


def _regions(fn: ast.AST, whole: bool) -> list[list[ast.AST]]:
    """The statement lists of `fn` that are card path: its `dispatch`
    spans when it has any (and `whole` is False), else its body; the CPU
    branch of a seam wrapper is cut out."""
    if not whole:
        spans = [
            node.body
            for node in ast.walk(fn)
            if isinstance(node, ast.With) and any(_span_name(i) == "dispatch" for i in node.items)
        ]
        if spans:
            return spans
    return [fn.body]


def _walk_region(stmts: list[ast.AST]):
    """ast.walk over statements, skipping the bodies of `if <cpu test>:`
    branches (the plain route) and nested defs (their own functions)."""
    stack = list(reversed(stmts))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ast.If) and _is_cpu_test(node.test):
            stack.extend(reversed([node.test] + node.orelse))
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _callees(stmts: list[ast.AST], cls: Optional[str], funcs: dict) -> set[str]:
    out = set()
    for node in _walk_region(stmts):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in funcs:
            out.add(f.id)
        elif (
            cls is not None
            and isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and f"{cls}.{f.attr}" in funcs
        ):
            out.add(f"{cls}.{f.attr}")
    return out


def card_path(tree: ast.Module, relpath: str, loops: Optional[dict] = None) -> dict[str, list]:
    """{qualified name: card-path statement lists} of one module: the
    seam wrappers, the launch functions and the round loops, and the
    same-module functions they call, minus the plain versions."""
    funcs = _functions(tree)
    loops = CARD_LOOPS if loops is None else loops
    listed = set(loops.get(relpath, ()))
    roots: dict[str, list] = {}
    for name, fn in funcs.items():
        if _is_plain(name):
            continue
        launcher = _calls_attr(fn, "budgets", "seam") or _calls_attr(fn, "budgets", "launched")
        if launcher or name in listed:
            roots[name] = _regions(fn, whole=launcher)
    out = dict(roots)
    work = list(roots)
    while work:
        name = work.pop()
        cls = name.split(".", 1)[0] if "." in name else None
        for callee in _callees([s for r in out[name] for s in r], cls, funcs):
            if callee not in out and not _is_plain(callee):
                out[callee] = [funcs[callee].body]
                work.append(callee)
    return out


# -- host syncs ---------------------------------------------------------------

_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# an expression that reads only host metadata of a tensor, or a host call
_STATIC_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda", "type"})
_STATIC_CALLS = frozenset(
    {"len", "numel", "dim", "size", "data_ptr", "element_size", "isinstance", "getattr", "sizeof", "monotonic"}
)
_HOST_ROOTS = frozenset({"lib", "ctypes", "os", "time", "math", "self", "args"})


def _params_with_constant_default(fn: ast.AST) -> set[str]:
    a = fn.args
    pos = a.posonlyargs + a.args
    out = set()
    for arg, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if isinstance(d, ast.Constant):
            out.add(arg.arg)
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(d, ast.Constant):
            out.add(arg.arg)
    return out


class _HostNames:
    """Which names in one function hold host scalars: a parameter with a
    constant default, or a local bound only from static expressions."""

    def __init__(self, fn: ast.AST):
        self.params = _params_with_constant_default(fn)
        self.assigns: dict[str, list[ast.AST]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.assigns.setdefault(t.id, []).append(node.value)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and isinstance(node.target, ast.Name):
                if node.value is not None:
                    self.assigns.setdefault(node.target.id, []).append(node.value)

    def static(self, expr: ast.AST, depth: int = 0) -> bool:
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, ast.Name):
            if expr.id in self.params or expr.id.isupper():  # a module constant
                return True
            values = self.assigns.get(expr.id)
            return bool(values) and depth < 4 and all(self.static(v, depth + 1) for v in values)
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
                return True
            if isinstance(sub, ast.Call):
                f = sub.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                if name in _STATIC_CALLS or base_name(f) in _HOST_ROOTS:
                    return True
        if isinstance(expr, (ast.Compare, ast.BoolOp, ast.UnaryOp, ast.BinOp)):
            return all(self.static(c, depth + 1) for c in ast.iter_child_nodes(expr) if isinstance(c, ast.expr))
        return False


def sync_desc(call: ast.Call, host: _HostNames) -> str:
    """How `call` syncs the host with the card, or '' (`host`: the
    calling function's host names)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_METHODS and not call.args and not call.keywords:
            return f".{f.attr}()"
        if f.attr == "nonzero":
            return "torch.nonzero" if base_name(f) == "torch" else ".nonzero()"
        if f.attr == "synchronize":
            return f"{ast.unparse(f)}()"
    elif isinstance(f, ast.Name) and f.id in ("int", "bool", "float") and len(call.args) == 1:
        arg = call.args[0]
        return "" if host.static(arg) else f"{f.id}({ast.unparse(arg)})"
    return ""


_TENSOR_TESTS = frozenset({"any", "all", "item", "equal"})


def tensor_test(test: ast.AST) -> str:
    """What tensor an `if`/`while` test reads, or ''."""
    for sub in ast.walk(test):
        if not isinstance(sub, ast.Call):
            continue
        root = base_name(sub.func)
        if root == "torch":
            return f"{ast.unparse(sub.func)}(...)"
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in _TENSOR_TESTS and root not in ("np", "numpy"):
            return f"{ast.unparse(sub.func)}()"
    return ""


def _load_budget_entries(repo_root: str) -> Optional[dict]:
    try:
        with open(os.path.join(repo_root, BUDGETS_MANIFEST), encoding="utf-8") as f:
            return json.load(f).get("entries", {})
    except (OSError, ValueError):
        return None


class _CardPathRule(Rule):
    targets = KERNEL_MODULES

    def __init__(self, loops: Optional[dict] = None, seams: Optional[dict] = None):
        self.loops = CARD_LOOPS if loops is None else loops
        self.seams = COUNTED_SEAMS if seams is None else seams
        self._budgets: dict[str, Optional[dict]] = {}

    def budget_entries(self, ctx: FileContext) -> Optional[dict]:
        root = ctx.config.repo_root
        if root not in self._budgets:
            self._budgets[root] = _load_budget_entries(root)
        return self._budgets[root]

    def sites(self, ctx: FileContext):
        """(qualified name, node, host names) over the card path."""
        funcs = _functions(ctx.tree)
        for name, regions in card_path(ctx.tree, ctx.relpath, self.loops).items():
            host = _HostNames(funcs[name])
            for stmts in regions:
                for node in _walk_region(stmts):
                    yield name, node, host


class KernelPurityRule(_CardPathRule):
    id = "kernel-purity"
    summary = (
        "no host sync (.item/.tolist/.cpu/.numpy, int/bool/float of a "
        "tensor, torch.nonzero, synchronize) on the card path outside the "
        "seams torch_budgets.json counts; the *_plain versions are exempt"
    )

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        seen: set[tuple[str, str]] = set()
        for name, node, host in self.sites(ctx):
            if not isinstance(node, ast.Call):
                continue
            desc = sync_desc(node, host)
            if not desc:
                continue
            seen.add((name, desc))
            seam = self.seams.get((ctx.relpath, name))
            if seam is not None and desc in seam["syncs"]:
                problem = self._seam_problem(ctx, seam)
                if problem:
                    out.append(ctx.finding(self.id, node, f"{desc} in {name}(): {problem}"))
                continue
            out.append(
                ctx.finding(
                    self.id,
                    node,
                    f"{desc} in {name}() syncs the host with the card on the "
                    "card path, and no counted seam names it: keep the value "
                    "on the card, or name the seam in rules_kernel.COUNTED_SEAMS "
                    "with the torch_budgets.json entry that counts it",
                )
            )
        funcs = _functions(ctx.tree)
        for (path, name), seam in self.seams.items():
            if path != ctx.relpath:
                continue
            stale = [d for d in seam["syncs"] if (name, d) not in seen]
            if stale:
                out.append(
                    ctx.finding(
                        self.id,
                        funcs[name] if name in funcs else 1,
                        f"counted seam {name}() lists {', '.join(stale)}, which "
                        "its card path no longer makes: drop it from "
                        "rules_kernel.COUNTED_SEAMS",
                    )
                )
        return out

    def _seam_problem(self, ctx: FileContext, seam: dict) -> str:
        entries = self.budget_entries(ctx)
        if entries is None:
            return f"the counted seam's manifest {BUDGETS_MANIFEST} is missing or malformed"
        entry = entries.get(seam["entry"])
        if entry is None or "host_syncs" not in entry.get("metrics", {}):
            return (
                f"the counted seam names {seam['entry']!r}, which "
                f"{BUDGETS_MANIFEST} lacks (or it counts no host_syncs)"
            )
        return ""


class TracerLeakRule(_CardPathRule):
    id = "tracer-leak"
    summary = (
        "no Python if/while on a tensor on the card path (a host sync "
        "hidden in control flow); keep the branch on the card (torch.where)"
    )

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        for name, node, _ in self.sites(ctx):
            if not isinstance(node, (ast.If, ast.While)) or _is_cpu_test(node.test):
                continue
            leak = tensor_test(node.test)
            if leak:
                kw = "if" if isinstance(node, ast.If) else "while"
                out.append(
                    ctx.finding(
                        self.id,
                        node,
                        f"`{kw}` in {name}() branches on a tensor ({leak}): "
                        "the host waits for the card; keep the branch on the "
                        "card (torch.where) or fetch once at a counted seam",
                    )
                )
        return out


RULES = (SharedComparatorRule, KernelPurityRule, TracerLeakRule)
