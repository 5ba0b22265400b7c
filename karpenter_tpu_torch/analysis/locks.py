"""graftlint race tier, static half: whole-program lock analysis.

A copy of the reference's `analysis/locks.py`, aimed at the port's tree
(engine.discover_files) and with the port's device syncs in its blocking
set (below).

The AST tier's `lock-discipline` rule is per-class and per-file: it can
prove a guarded attribute is never written bare, but it cannot see a
lock-ORDER inversion (thread 1 takes A then B, thread 2 takes B then A —
each side locally consistent, jointly a deadlock), a blocking call made
while a lock is held (every contending thread stalls behind the socket /
sleep / device sync), or a write racing between a `threading.Thread`
body and the public surface of the same object. Those are the classic
lockset/happens-before bugs (Eraser, ThreadSanitizer), and this module
finds the statically findable slice of them:

- Inventory: every `threading.Lock/RLock/Condition/Event` bound to a
  `self.<attr>` in a class body or a module-level name, across the whole
  package and tests (an inversion is a property of the PROGRAM, not of
  one file).
- Held spans: `with self.<lock>:` blocks (including multi-item withs,
  in item order), `acquire()`…`release()` statement pairs, and the
  `*_locked`-suffix convention (the caller holds a lock by contract —
  same convention the AST tier's lock-discipline rule honors).
- Acquisition graph: a directed edge A -> B for every place lock B is
  acquired while A is held, followed INTERPROCEDURALLY through
  same-class method calls (`self.m()` under a lock inherits the held
  set) and same-module function calls.

Rules (engine-integrated: suppressions, torch_graftlint.race.baseline.json,
`--json`, exit codes as the reference's):

- `race-lock-order`: a cycle in the acquisition graph (two locks taken
  in both orders somewhere in the program), or a non-reentrant
  Lock/Condition re-acquired while already held on the same path (a
  guaranteed self-deadlock). The runtime half (analysis/racert.py)
  witnesses the same property dynamically under the fault suite.
- `race-blocking-hold`: a blocking call in a held span — socket
  recv/send/accept/connect, `subprocess.*`, `time.sleep`, a queue-style
  `.get()` with no timeout, and device syncs while every contending
  thread waits: in modules that import torch, the card path's host syncs
  (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `int/bool/float` of a
  tensor, `torch.nonzero`, and an `if`/`while` on a tensor; the same
  definitions as the AST tier's kernel-purity rule, rules_kernel.py);
  anywhere, `.synchronize()` (torch.cuda, an Event or a Stream); and, as
  in the reference, in modules that import jax, `block_until_ready`,
  `.item()`, `np.asarray`/`np.array` and `jax.device_get`.
- `race-unguarded-shared`: an attribute written both from a
  `threading.Thread(target=self.<m>)` body and from the class's public
  surface — each side followed transitively through same-class calls,
  so `stop()` delegating to `_shutdown()` counts as a public write —
  with no COMMON lock guarding every write; the interprocedural upgrade
  of the AST tier's lock-discipline rule, which only sees attributes
  that were formally guarded somewhere.

Pure stdlib `ast`: importing this module never pulls in torch, numpy or
JAX.
"""

from __future__ import annotations

import ast
import os
from typing import Optional

from karpenter_tpu_torch.analysis import rules_kernel
from karpenter_tpu_torch.analysis.engine import (
    RACE_DEFAULT_BASELINE,
    Baseline,
    Config,
    FileContext,
    Finding,
    base_name,
    discover_files,
)

RACE_RULES: dict[str, str] = {
    "race-lock-order": (
        "the program-wide lock acquisition graph must be acyclic, and "
        "non-reentrant locks must not be re-acquired on a path that "
        "already holds them"
    ),
    "race-blocking-hold": (
        "no blocking call (socket I/O, subprocess, sleep, untimed "
        "queue get, device sync) while holding a threading lock"
    ),
    "race-unguarded-shared": (
        "attributes written from both a threading.Thread target and a "
        "public method need one common lock guarding every write"
    ),
}

DEFAULT_BASELINE = RACE_DEFAULT_BASELINE

# constructor names inventoried as locks; Event carries no ordering (it
# is never held) and is inventoried only so the model knows the attr is
# synchronization state, not shared data
_HELD_KINDS = frozenset({"Lock", "RLock", "Condition"})
_LOCK_CTORS = _HELD_KINDS | frozenset({"Event"})
_REENTRANT = frozenset({"RLock", "Condition"})  # Condition wraps an RLock

# mutator methods that write their receiver in place (the AST tier's
# lock-discipline list, minus dict.get-style readers)
_MUTATORS = frozenset(
    {
        "add",
        "append",
        "appendleft",
        "clear",
        "discard",
        "extend",
        "insert",
        "pop",
        "popleft",
        "remove",
        "setdefault",
        "update",
    }
)

_SOCKET_BLOCKING = frozenset(
    {"recv", "recv_into", "recvfrom", "accept", "send", "sendall", "connect"}
)
_SUBPROCESS_BLOCKING = frozenset(
    {"run", "call", "check_call", "check_output", "Popen", "communicate"}
)

# the caller-holds-a-lock-by-contract convention (lock-discipline rule)
_LOCKED_SUFFIX = "_locked"

# the wildcard guard: a write inside a *_locked method is guarded by
# whatever lock the caller holds — it never breaks a common-guard claim
_ANY_GUARD = "*"


def _self_attr(node: ast.AST) -> str:
    """'x' for self.x / self.x[...] expressions, else ''."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return ""


def _lock_ctor_kind(value: ast.AST) -> Optional[str]:
    """'Lock' / 'RLock' / 'Condition' / 'Event' when `value` is a call to
    one of the threading constructors (either spelling), else None."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    name = (
        f.attr
        if isinstance(f, ast.Attribute)
        else f.id
        if isinstance(f, ast.Name)
        else None
    )
    return name if name in _LOCK_CTORS else None


# ---------------------------------------------------------------------------
# per-file program model


class _Scope:
    """One lock-owning scope: a class (locks are `self.<attr>`) or the
    module itself (locks are module-level names). Functions inside the
    scope share the lock namespace and the call graph. Class scopes also
    see their module's locks (`module_locks`) — a method may hold a
    module-level lock, and that hold must land on the SAME graph node as
    module-function holds of it. Refs for module locks carry an `@`
    prefix ("@" cannot appear in an identifier), so a class lock attr
    and a module lock of the same name never alias."""

    def __init__(
        self,
        ctx: FileContext,
        name: str,
        is_class: bool,
        module_locks: Optional[dict[str, str]] = None,
    ):
        self.ctx = ctx
        self.name = name  # class name, or "<module>"
        self.is_class = is_class
        self.locks: dict[str, str] = {}  # attr/name -> kind
        self.module_locks: dict[str, str] = module_locks or {}
        self.lock_lines: dict[str, int] = {}
        self.functions: dict[str, "_Func"] = {}
        self.thread_targets: list[tuple[str, int]] = []  # (method, lineno)

    def kind_of(self, ref: str) -> Optional[str]:
        if ref.startswith("@"):
            return self.module_locks.get(ref[1:])
        return self.locks.get(ref)

    def lock_id(self, ref: str) -> str:
        if ref.startswith("@"):
            return f"{self.ctx.relpath}::<module>.{ref[1:]}"
        return f"{self.ctx.relpath}::{self.name}.{ref}"

    def lock_label(self, ref: str) -> str:
        if ref.startswith("@"):
            return ref[1:]
        return ref if self.name == "<module>" else f"{self.name}.{ref}"


class _Func:
    """One function/method in a scope, reduced to what the race rules
    need: held spans, nested acquisitions, intra-scope calls, blocking
    calls, and attribute writes — each tagged with the locks held there."""

    def __init__(self, scope: _Scope, node: ast.FunctionDef):
        self.scope = scope
        self.node = node
        self.name = node.name
        self.locked_by_contract = node.name.endswith(_LOCKED_SUFFIX)
        # (lock attr, span lo, span hi, acquisition line)
        self.spans: list[tuple[str, int, int, int]] = []
        self.calls: list[tuple[str, int]] = []  # (callee name, line)
        self.blocking: list[tuple[ast.AST, str]] = []  # (node, description)
        # (attr, node, guards held at the write)
        self.writes: list[tuple[str, ast.AST, frozenset[str]]] = []
        # (if-body line range, else line range) pairs: an acquire() span
        # runs to the NEXT release line, so a span opened in one branch
        # textually covers the sibling branch that can never execute
        # with it — lines in opposite branches must not read as "held"
        self.exclusive: list[tuple[tuple[int, int], tuple[int, int]]] = []

    def mutually_exclusive(self, a: int, b: int) -> bool:
        for r1, r2 in self.exclusive:
            if (r1[0] <= a <= r1[1] and r2[0] <= b <= r2[1]) or (
                r1[0] <= b <= r1[1] and r2[0] <= a <= r2[1]
            ):
                return True
        return False

    def held_at(self, line: int) -> list[str]:
        out = []
        for span in self.spans:
            attr, lo, hi, acq = span
            if (
                lo <= line <= hi
                and attr not in out
                and not self.mutually_exclusive(acq, line)
            ):
                out.append(attr)
        return out

    def acquired_locks(self) -> set[str]:
        return {attr for attr, _, _, _ in self.spans}


def _lock_ref(scope: _Scope, expr: ast.AST) -> str:
    """The scope-local lock ref an expression refers to, or ''. In a
    class scope: `self.<attr>` for own locks, `@name` for module-level
    locks (methods may hold module locks); in the module scope: bare
    names."""
    if scope.is_class:
        attr = _self_attr(expr)
        if attr in scope.locks:
            return attr
        if isinstance(expr, ast.Name) and expr.id in scope.module_locks:
            return "@" + expr.id
    elif isinstance(expr, ast.Name) and expr.id in scope.locks:
        return expr.id
    return ""


def _walk_skip_nested_classes(root: ast.AST):
    """ast.walk, minus ClassDef subtrees below the root."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.ClassDef):
                stack.append(child)


def _build_scope(
    ctx: FileContext,
    name: str,
    body: list,
    is_class: bool,
    module_locks: Optional[dict[str, str]] = None,
) -> _Scope:
    scope = _Scope(ctx, name, is_class, module_locks=module_locks)
    # pass 1: lock inventory. Classes: anywhere in the body (__init__
    # included) EXCEPT nested ClassDef subtrees — an inner class's
    # `self._x` is a different object than the outer class's, and
    # conflating them both invents phantom held spans on the outer class
    # and splits one real lock role across two graph identities.
    # Modules: top-level assignments only — a local `lock = Lock()`
    # inside a function is not shared module state.
    candidates = (
        [
            sub
            for node in body
            if not isinstance(node, ast.ClassDef)
            for sub in _walk_skip_nested_classes(node)
        ]
        if is_class
        else list(body)
    )
    for sub in candidates:
        # `self._lock: threading.Lock = threading.Lock()` declares the
        # same shared lock as the bare assignment — missing AnnAssign
        # would silently drop the lock (and every rule over it) from the
        # whole-program analysis
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
            targets = [sub.target]
        else:
            continue
        kind = _lock_ctor_kind(sub.value)
        if kind is None:
            continue
        for t in targets:
            ref = _self_attr(t) if is_class else (
                t.id if isinstance(t, ast.Name) else ""
            )
            if ref:
                scope.locks[ref] = kind
                scope.lock_lines.setdefault(ref, sub.lineno)
    # pass 2: per-function reduction
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.functions[node.name] = _reduce_function(scope, node)
    return scope


def _body_region(body: list) -> tuple[int, int]:
    return (body[0].lineno, max(n.end_lineno or n.lineno for n in body))


def _reduce_function(scope: _Scope, fn: ast.FunctionDef) -> _Func:
    info = _Func(scope, fn)
    imports = _file_imports(scope.ctx)
    jaxy = "jax" in imports
    host = rules_kernel._HostNames(fn) if "torch" in imports else None
    acquires: dict[str, list[int]] = {}
    releases: dict[str, list[int]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and node.orelse:
            info.exclusive.append(
                (_body_region(node.body), _body_region(node.orelse))
            )
        if isinstance(node, ast.With):
            for item in node.items:
                ref = _lock_ref(scope, item.context_expr)
                if ref and scope.kind_of(ref) in _HELD_KINDS:
                    info.spans.append(
                        (ref, node.lineno, node.end_lineno or node.lineno, node.lineno)
                    )
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                ref = _lock_ref(scope, f.value)
                if ref and scope.kind_of(ref) in _HELD_KINDS:
                    if f.attr == "acquire":
                        acquires.setdefault(ref, []).append(node.lineno)
                    elif f.attr == "release":
                        releases.setdefault(ref, []).append(node.lineno)
                # intra-scope method call
                if (
                    scope.is_class
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                ):
                    info.calls.append((f.attr, node.lineno))
            elif isinstance(f, ast.Name) and not scope.is_class:
                info.calls.append((f.id, node.lineno))
            desc = _blocking_desc(node, jaxy, host)
            if desc:
                info.blocking.append((node, desc))
        elif isinstance(node, (ast.If, ast.While)) and host is not None:
            leak = rules_kernel.tensor_test(node.test)
            if leak:
                info.blocking.append((node, f"device sync: a branch on a tensor ({leak})"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                attr = _self_attr(t) if scope.is_class else ""
                if attr:
                    info.writes.append((attr, node, frozenset()))
        # in-place mutator calls write their receiver
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
        ):
            attr = _self_attr(node.func.value) if scope.is_class else ""
            if attr:
                info.writes.append((attr, node, frozenset()))
    # acquire()/release() statement pairs become held spans: each acquire
    # is paired with the next release of the same lock (function end when
    # none follows — a leaked hold spans the rest of the body)
    end = fn.end_lineno or fn.lineno
    for ref, acq_lines in acquires.items():
        rel_lines = sorted(releases.get(ref, []))
        for a in sorted(acq_lines):
            hi = next((r for r in rel_lines if r >= a), end)
            info.spans.append((ref, a, hi, a))
    # writes get their guard sets now that every span is known
    guarded_writes = []
    for attr, node, _ in info.writes:
        held = frozenset(info.held_at(node.lineno))
        if info.locked_by_contract:
            held = held | {_ANY_GUARD}
        guarded_writes.append((attr, node, held))
    info.writes = guarded_writes
    # thread targets: threading.Thread(target=self.<m>) in a class scope
    if scope.is_class:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            is_thread = (
                isinstance(f, ast.Attribute) and f.attr == "Thread"
            ) or (isinstance(f, ast.Name) and f.id == "Thread")
            if not is_thread:
                continue
            for kw in node.keywords:
                if kw.arg == "target":
                    target = _self_attr(kw.value)
                    if target:
                        scope.thread_targets.append((target, node.lineno))
    return info


def _file_imports(ctx: FileContext) -> frozenset:
    """Which of jax and torch the file imports."""
    cached = getattr(ctx, "_race_imports", None)
    if cached is None:
        found = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for lib in ("jax", "torch"):
                if any(n == lib or n.startswith(lib + ".") for n in names):
                    found.add(lib)
        cached = ctx._race_imports = frozenset(found)
    return cached


def _blocking_desc(call: ast.Call, jax_module: bool, torch_host=None) -> str:
    """A human-readable description when `call` is a blocking construct,
    else ''. Device-sync patterns only count in modules importing jax or
    torch (`torch_host`: the function's host names, rules_kernel) —
    `np.asarray` on host arrays is ordinary numpy, not a device fetch."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "synchronize":
        return f"device sync {ast.unparse(f)}()"
    if torch_host is not None:
        desc = rules_kernel.sync_desc(call, torch_host)
        if desc:
            return f"device sync {desc}"
    if isinstance(f, ast.Attribute):
        root = base_name(f)
        if f.attr in _SOCKET_BLOCKING and root not in ("subprocess",):
            return f"socket-style .{f.attr}()"
        if root == "subprocess" and f.attr in _SUBPROCESS_BLOCKING:
            return f"subprocess.{f.attr}()"
        if f.attr == "sleep" and root in ("time", None):
            return "time.sleep()"
        if f.attr == "get" and not call.args:
            kwargs = {kw.arg: kw.value for kw in call.keywords}
            block_false = isinstance(
                kwargs.get("block"), ast.Constant
            ) and kwargs["block"].value is False
            # dict.get always has a positional key; a zero-positional
            # .get() is queue-style. **kwargs (arg None) is unknowable —
            # do not guess
            if "timeout" not in kwargs and not block_false and None not in kwargs:
                return "queue-style .get() with no timeout"
        if jax_module:
            if f.attr == "block_until_ready":
                return "device sync .block_until_ready()"
            if f.attr == "item" and not call.args:
                return "device sync .item()"
            if f.attr in ("asarray", "array") and root in ("np", "numpy"):
                return f"device fetch {root}.{f.attr}()"
            if f.attr == "device_get" and root == "jax":
                return "device fetch jax.device_get()"
    elif isinstance(f, ast.Name) and f.id == "sleep":
        return "sleep()"
    return ""


# ---------------------------------------------------------------------------
# the acquisition graph


class _Edge:
    __slots__ = ("src", "dst", "ctx", "line", "detail")

    def __init__(self, src: str, dst: str, ctx: FileContext, line: int, detail: str):
        self.src = src
        self.dst = dst
        self.ctx = ctx
        self.line = line
        self.detail = detail


def _reachable(scope: _Scope, entry: str):
    """The transitive same-scope call closure every interprocedural rule
    walks: yields (name, fn, path) for each DEFINED function reachable
    from `entry`, where `path` is the call chain ending in `name`. One
    traversal, or the rules silently diverge on a future fix (shadowed
    names, following `*_locked` contracts, ...)."""
    seen: set[str] = set()
    stack: list[tuple[str, tuple[str, ...]]] = [(entry, ())]
    while stack:
        name, path = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        fn = scope.functions.get(name)
        if fn is None:
            continue
        path = path + (name,)
        yield name, fn, path
        for callee, _ in fn.calls:
            stack.append((callee, path))


def _closure_acquires(scope: _Scope, entry: str) -> dict[str, tuple[str, ...]]:
    """Locks acquired by `entry` or anything it transitively calls inside
    the scope: lock attr -> call path (for the finding message)."""
    out: dict[str, tuple[str, ...]] = {}
    for _, fn, path in _reachable(scope, entry):
        for attr in fn.acquired_locks():
            out.setdefault(attr, path)
    return out


def _closure_held(scope: _Scope, entry: str) -> dict[str, frozenset[str]]:
    """Locks GUARANTEED held whenever each function in `entry`'s call
    closure runs (entered via `entry`): the meet (intersection) over all
    call paths, where a call made at a line with locks held passes those
    locks down to the callee. This is what lets a write in `_shutdown()`
    keep its guard when the only caller is `with self._lock:
    self._shutdown()` — without it, guarded delegation reads as an
    unguarded write. Standard decreasing-fixpoint dataflow; the call
    graphs here are a handful of methods, so it converges immediately."""
    out: dict[str, frozenset[str]] = {entry: frozenset()}
    work = [entry]
    while work:
        name = work.pop()
        fn = scope.functions.get(name)
        if fn is None:
            continue
        held_here = out[name]
        for callee, line in fn.calls:
            if callee not in scope.functions:
                continue
            ctx = held_here | frozenset(fn.held_at(line))
            prev = out.get(callee)
            new = ctx if prev is None else prev & ctx
            if prev is None or new != prev:
                out[callee] = new
                work.append(callee)
    return out


def _entries_held(
    scope: _Scope, entries: list[str]
) -> dict[str, frozenset[str]]:
    """`_closure_held` met across several entry points: the locks held at
    a function no matter which of `entries` the thread came in through."""
    out: dict[str, frozenset[str]] = {}
    for entry in entries:
        for name, held in _closure_held(scope, entry).items():
            prev = out.get(name)
            out[name] = held if prev is None else prev & held
    return out


def _scope_edges(scope: _Scope) -> list[_Edge]:
    edges: list[_Edge] = []
    for fn in scope.functions.values():
        # nested held spans: B acquired at its span start while A held.
        # Strictly-earlier acquisition lines only: two locks in ONE
        # multi-item `with` share a lineno and are ordered by item
        # position below, not symmetrically here.
        for span in fn.spans:
            attr_b, _, _, acq_line = span
            holders = [
                s[0]
                for s in fn.spans
                if s is not span
                and s[3] < acq_line
                and s[1] <= acq_line <= s[2]
                # acquires in opposite if/else branches never coexist:
                # `if fast: lock.acquire() else: lock.acquire()` is one
                # hold, not a self-deadlock (span hi bleeds to the next
                # release, textually covering the sibling branch)
                and not fn.mutually_exclusive(s[3], acq_line)
            ]
            for attr_a in dict.fromkeys(holders):
                edges.append(
                    _Edge(
                        scope.lock_id(attr_a),
                        scope.lock_id(attr_b),
                        scope.ctx,
                        acq_line,
                        f"{scope.lock_label(attr_b)} acquired at "
                        f"{scope.ctx.relpath}:{acq_line} in {fn.name}() while "
                        f"holding {scope.lock_label(attr_a)}",
                    )
                )
        # multi-item withs acquire in item order even at the same line
        for node in ast.walk(fn.node):
            if isinstance(node, ast.With) and len(node.items) > 1:
                refs = [
                    r
                    for r in (_lock_ref(scope, i.context_expr) for i in node.items)
                    if r and scope.kind_of(r) in _HELD_KINDS
                ]
                for i in range(len(refs) - 1):
                    for j in range(i + 1, len(refs)):
                        edges.append(
                            _Edge(
                                scope.lock_id(refs[i]),
                                scope.lock_id(refs[j]),
                                scope.ctx,
                                node.lineno,
                                f"with {scope.lock_label(refs[i])}, "
                                f"{scope.lock_label(refs[j])}: at "
                                f"{scope.ctx.relpath}:{node.lineno}",
                            )
                        )
        # interprocedural: a call made while holding A inherits the held
        # set — every lock the callee closure acquires becomes an edge
        for callee, line in fn.calls:
            held = fn.held_at(line)
            if not held or callee not in scope.functions:
                continue
            for attr_b, path in _closure_acquires(scope, callee).items():
                for attr_a in held:
                    edges.append(
                        _Edge(
                            scope.lock_id(attr_a),
                            scope.lock_id(attr_b),
                            scope.ctx,
                            line,
                            f"{fn.name}() holds {scope.lock_label(attr_a)} and "
                            f"calls {'() -> '.join(path)}(), which acquires "
                            f"{scope.lock_label(attr_b)}",
                        )
                    )
    return edges


def _find_cycles(
    edges: list[_Edge], kinds: dict[str, str]
) -> list[tuple[list[_Edge], str]]:
    """Cycles in the acquisition graph. Self-loops on a non-reentrant
    lock are reported (a guaranteed deadlock); RLock/Condition self-loops
    are legal re-entry and skipped. Multi-node cycles always count —
    reentrancy does not save an A->B->A inversion. Returns one
    representative edge path per distinct cycle node-set."""
    by_src: dict[str, list[_Edge]] = {}
    for e in edges:
        by_src.setdefault(e.src, []).append(e)
    cycles: list[tuple[list[_Edge], str]] = []
    seen_sets: set[frozenset] = set()

    for e in edges:
        if e.src == e.dst:
            if kinds.get(e.src) in _REENTRANT:
                continue
            key = frozenset((e.src, "self"))
            if key in seen_sets:
                continue
            seen_sets.add(key)
            cycles.append(([e], "self-deadlock"))

    # DFS from each node for a path back to itself (graphs here are tiny:
    # a handful of locks per program)
    nodes = sorted({e.src for e in edges} | {e.dst for e in edges})
    for start in nodes:
        stack: list[tuple[str, list[_Edge]]] = [(start, [])]
        visited: set[str] = set()
        while stack:
            node, path = stack.pop()
            for e in by_src.get(node, ()):
                if e.src == e.dst:
                    continue
                if e.dst == start and path:
                    key = frozenset(x.src for x in path + [e])
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycles.append((path + [e], "inversion"))
                elif e.dst not in visited and e.dst != start:
                    visited.add(e.dst)
                    stack.append((e.dst, path + [e]))
    return cycles


# ---------------------------------------------------------------------------
# rules


def _check_lock_order(scopes: list[_Scope]) -> list[Finding]:
    edges: list[_Edge] = []
    kinds: dict[str, str] = {}
    for scope in scopes:
        for attr, kind in scope.locks.items():
            kinds[scope.lock_id(attr)] = kind
        edges.extend(_scope_edges(scope))
    findings = []
    for cycle, why in _find_cycles(edges, kinds):
        anchor = min(cycle, key=lambda e: (e.ctx.relpath, e.line))
        if why == "self-deadlock":
            e = cycle[0]
            name = e.src.split("::", 1)[1]
            msg = (
                f"non-reentrant {kinds.get(e.src, 'Lock')} {name} is "
                f"re-acquired on a path that already holds it "
                f"({e.detail}) — guaranteed self-deadlock"
            )
        else:
            order = " -> ".join(
                e.src.split("::", 1)[1] for e in cycle
            ) + " -> " + cycle[0].src.split("::", 1)[1]
            msg = (
                f"lock-order cycle {order} (potential deadlock): "
                + "; ".join(e.detail for e in cycle)
            )
        findings.append(anchor.ctx.finding("race-lock-order", anchor.line, msg))
    return findings


def _check_blocking_hold(scopes: list[_Scope]) -> list[Finding]:
    findings = []
    for scope in scopes:
        for fn in scope.functions.values():
            # blocking calls directly under a held span (or in a *_locked
            # method, where the caller holds a lock by contract)
            for node, desc in fn.blocking:
                held = fn.held_at(node.lineno)
                if held:
                    lock = scope.lock_label(held[0])
                elif fn.locked_by_contract and scope.locks:
                    lock = f"the caller's lock ({fn.name} is *_locked)"
                else:
                    continue
                findings.append(
                    scope.ctx.finding(
                        "race-blocking-hold",
                        node,
                        f"blocking call ({desc}) while holding {lock} — "
                        "every thread contending the lock stalls behind it",
                    )
                )
            # interprocedural: calling into a function whose closure
            # blocks, while holding a lock
            for callee, line in fn.calls:
                held = fn.held_at(line)
                if not held or callee not in scope.functions:
                    continue
                for bnode, bdesc, path in _closure_blocking(scope, callee):
                    findings.append(
                        scope.ctx.finding(
                            "race-blocking-hold",
                            line,
                            f"{fn.name}() holds {scope.lock_label(held[0])} "
                            f"and calls {'() -> '.join(path)}(), which makes "
                            f"a blocking call ({bdesc} at "
                            f"{scope.ctx.relpath}:{bnode.lineno})",
                        )
                    )
    return findings


def _closure_blocking(
    scope: _Scope, entry: str
) -> list[tuple[ast.AST, str, tuple[str, ...]]]:
    out = []
    for _, fn, path in _reachable(scope, entry):
        for node, desc in fn.blocking:
            # blocked-under-own-lock — and blocking inside a *_locked
            # method — is already reported at the definition; only
            # unguarded blocking calls propagate to callers (one defect,
            # one finding)
            if fn.held_at(node.lineno):
                continue
            if fn.locked_by_contract and scope.locks:
                continue
            out.append((node, desc, path))
    return out


def _check_unguarded_shared(scopes: list[_Scope]) -> list[Finding]:
    findings = []
    for scope in scopes:
        if not scope.is_class or not scope.thread_targets:
            continue
        closure: set[str] = set()
        for target, _ in scope.thread_targets:
            closure.update(name for name, _, _ in _reachable(scope, target))
        # the public surface follows the same call closure as the thread
        # side: `stop()` delegating to `_shutdown()` writes shared state
        # from public code just as surely as an inline assignment would
        # (methods in BOTH closures count as thread-side — that is where
        # the write actually races)
        public_closure: set[str] = set()
        for entry in scope.functions:
            if entry.startswith("_") or entry in closure:
                continue
            public_closure.update(
                name for name, _, _ in _reachable(scope, entry)
            )
        # gather writes per attribute on each side (construction in
        # __init__ is exempt: the object is not shared yet). A write's
        # guard set is its function-local held set PLUS whatever its
        # side's entry points guarantee is held on the way in — so
        # `with self._lock: self._shutdown()` keeps `_shutdown`'s writes
        # guarded instead of reading as bare.
        thread_held = _entries_held(
            scope, [target for target, _ in scope.thread_targets]
        )
        public_held = _entries_held(
            scope,
            [
                entry
                for entry in scope.functions
                if not entry.startswith("_") and entry not in closure
            ],
        )
        thread_writes: dict[str, list[tuple[ast.AST, frozenset, str]]] = {}
        public_writes: dict[str, list[tuple[ast.AST, frozenset, str]]] = {}
        for name, fn in scope.functions.items():
            if name == "__init__":
                continue
            if name in closure:
                side, inherited = thread_writes, thread_held.get(name)
            elif name in public_closure:
                side, inherited = public_writes, public_held.get(name)
            else:
                continue
            for attr, node, guards in fn.writes:
                if attr in scope.locks:
                    continue
                side.setdefault(attr, []).append(
                    (node, guards | (inherited or frozenset()), name)
                )
        for attr in sorted(set(thread_writes) & set(public_writes)):
            all_writes = thread_writes[attr] + public_writes[attr]
            common: Optional[frozenset] = None
            for _, guards, _ in all_writes:
                if _ANY_GUARD in guards:
                    continue
                common = guards if common is None else common & guards
            if common is None or common:
                continue  # every write shares at least one lock
            # anchor at an unguarded write when one exists, preferring
            # the thread side (that is the surprising half)
            anchor = next(
                (w for w in thread_writes[attr] if not w[1]),
                next((w for w in all_writes if not w[1]), all_writes[0]),
            )
            node, _, method = anchor
            t_names = sorted({m for _, _, m in thread_writes[attr]})
            p_names = sorted({m for _, _, m in public_writes[attr]})
            findings.append(
                scope.ctx.finding(
                    "race-unguarded-shared",
                    node,
                    f"{scope.name}.{attr} is written from Thread-target "
                    f"code ({', '.join(t_names)}) and from the public surface "
                    f"({', '.join(p_names)}) with no common lock across "
                    f"every write (anchored at the {method}() write) — "
                    "guard both sides with one lock",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# the pipeline


def build_program(
    files: list[str], config: Config
) -> tuple[list[_Scope], dict[str, FileContext], list[str]]:
    """Parse every file into scopes. Unparsable files are reported, never
    silently skipped (the engine's contract)."""
    scopes: list[_Scope] = []
    contexts: dict[str, FileContext] = {}
    errors: list[str] = []
    for path in sorted(files):
        rel = os.path.relpath(path, config.repo_root)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            ctx = FileContext(path, rel, source, config)
        except (OSError, SyntaxError) as e:
            errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        contexts[ctx.relpath] = ctx
        module_body = [
            n
            for n in ctx.tree.body
            if not isinstance(n, ast.ClassDef)
        ]
        # module scope first: classes resolve module-level lock names
        # against it, so a method holding a module lock lands on the
        # same graph node as a module function holding it
        mod_scope = _build_scope(ctx, "<module>", module_body, is_class=False)
        scopes.append(mod_scope)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                scopes.append(
                    _build_scope(
                        ctx,
                        node.name,
                        node.body,
                        is_class=True,
                        module_locks=mod_scope.locks,
                    )
                )
    return scopes, contexts, errors


def analyze_program(
    scopes: list[_Scope],
    contexts: dict[str, FileContext],
    rule_ids: Optional[set[str]] = None,
) -> list[Finding]:
    active = set(RACE_RULES) if rule_ids is None else set(rule_ids)
    findings: list[Finding] = []
    if "race-lock-order" in active:
        findings.extend(_check_lock_order(scopes))
    if "race-blocking-hold" in active:
        findings.extend(_check_blocking_hold(scopes))
    if "race-unguarded-shared" in active:
        findings.extend(_check_unguarded_shared(scopes))
    out, seen = [], set()
    for f in findings:
        ctx = contexts.get(f.path)
        key = (f.path, f.line, f.rule, f.message)
        if key in seen or (ctx is not None and ctx.suppressed(f)):
            continue
        seen.add(key)
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return out


def run_race_analysis(
    repo_root: str,
    baseline_path: Optional[str] = None,
    rule_ids: Optional[set[str]] = None,
) -> dict:
    """The full static race pipeline, mirroring engine.run_analysis:
    whole-program model, rules, baseline. Returns {"findings": [...],
    "all_findings": [...], "stale": [...], "errors": [...],
    "unjustified": [...], "total": int}."""
    config = Config.for_repo(repo_root)
    files = discover_files(repo_root)
    scopes, contexts, errors = build_program(files, config)
    findings = analyze_program(scopes, contexts, rule_ids=rule_ids)
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
