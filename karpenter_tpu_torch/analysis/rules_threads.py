"""Rules guarding shared mutable state: the reference's rules over the port.

- lock-discipline: the threaded service boundary (solver/service.py
  handler threads, the epoch store, the fleet coalescer's windows, the
  kernel build, metrics scraped while worker pools observe) relies on
  every write to a lock-guarded attribute actually holding the lock.
  Two checks per class that owns a threading lock:
    (a) an attribute ever written under `with self._lock:` must never be
        written outside one (construction in __init__ is exempt — the
        object is not shared yet);
    (b) `self.x += ...` outside a lock is a read-modify-write race even
        when the attribute was never formally guarded.
- cache-invalidation: relax mutations change every field the memoized
  `_ktpu_*` class keys cover (solver/ordering.py); mutations of
  preference state must invalidate those caches, or the encoder dedups a
  relaxed pod into its pre-relaxation class.
"""

from __future__ import annotations

import ast

from karpenter_tpu_torch.analysis.engine import FileContext, Finding, Rule

# the port's lock-owning modules
LOCK_MODULES = (
    "karpenter_tpu_torch/_build.py",
    "karpenter_tpu_torch/metrics.py",
    "karpenter_tpu_torch/tracing.py",
    "karpenter_tpu_torch/logging.py",
    "karpenter_tpu_torch/profiling.py",
    "karpenter_tpu_torch/solver/service.py",
    "karpenter_tpu_torch/solver/hybrid.py",
    "karpenter_tpu_torch/solver/epochs.py",
    "karpenter_tpu_torch/solver/fleet.py",
    "karpenter_tpu_torch/solver/aot.py",
    "karpenter_tpu_torch/controllers/kube.py",
    "karpenter_tpu_torch/controllers/termination.py",
    "karpenter_tpu_torch/cloudprovider/fake.py",
    "karpenter_tpu_torch/testing/faults.py",
    "karpenter_tpu_torch/analysis/*.py",
    "chip_smoke.py",
    "tools/*.py",
    "tests/*.py",
    "tests/**/*.py",
)

_LOCK_TYPES = frozenset({"Lock", "RLock", "Condition", "Semaphore"})
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


def _self_attr(node: ast.AST) -> str:
    """'x' for self.x / self.x[...] targets, else ''."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return ""


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    summary = (
        "attributes written under a threading lock must never be written "
        "outside a `with self.<lock>:` block"
    )
    targets = LOCK_MODULES

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef) -> list[Finding]:
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return []
        methods = [
            m
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
            and m.name != "__init__"
        ]
        guarded_spans: list[tuple[int, int]] = []
        writes: list[tuple[ast.AST, str, bool]] = []  # (node, attr, is_aug)
        for m in methods:
            if m.name.endswith("_locked"):
                # the `_locked` suffix is the contract that the caller
                # holds the lock; the whole body counts as guarded
                guarded_spans.append((m.lineno, m.end_lineno or m.lineno))
            for node in ast.walk(m):
                if isinstance(node, ast.With):
                    if any(
                        _self_attr(item.context_expr) in lock_attrs
                        for item in node.items
                    ):
                        guarded_spans.append(
                            (node.lineno, node.end_lineno or node.lineno)
                        )
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        attr = _self_attr(t)
                        if attr:
                            writes.append(
                                (node, attr, isinstance(node, ast.AugAssign))
                            )
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    if node.func.attr in _MUTATORS:
                        attr = _self_attr(node.func.value)
                        if attr:
                            writes.append((node, attr, False))

        def under_lock(n: ast.AST) -> bool:
            return any(lo <= n.lineno <= hi for lo, hi in guarded_spans)

        guarded_attrs = {
            attr for n, attr, _ in writes if under_lock(n)
        } - lock_attrs
        findings = []
        for n, attr, is_aug in writes:
            if attr in lock_attrs or under_lock(n):
                continue
            if attr in guarded_attrs:
                findings.append(
                    ctx.finding(
                        self.id,
                        n,
                        f"{cls.name}.{attr} is written under a lock "
                        "elsewhere but written here without one — a "
                        "torn/lost update under the handler threads",
                    )
                )
            elif is_aug:
                findings.append(
                    ctx.finding(
                        self.id,
                        n,
                        f"read-modify-write on {cls.name}.{attr} outside "
                        "any lock in a lock-owning class; increments can "
                        "be lost under preemption",
                    )
                )
        return findings

    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> set[str]:
        attrs: set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            # both spellings: threading.Lock() and bare Lock() from a
            # `from threading import Lock`
            ctor = (
                v.func.attr
                if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                else v.func.id
                if isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                else None
            )
            if ctor in _LOCK_TYPES:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr:
                        attrs.add(attr)
        return attrs


# pod fields covered by the memoized class key (solver/ordering.py
# pod_class_key); mutating any of these without dropping the _ktpu_* caches
# dedups the pod into a stale class
_SENSITIVE = frozenset(
    {
        "node_affinity",
        "required_terms",
        "preferred",
        "tolerations",
        "topology_spread_constraints",
        "pod_affinity",
        "pod_anti_affinity",
        "pod_affinity_preferred",
        "pod_anti_affinity_preferred",
        "node_selector",
    }
)
_LIST_MUTATORS = frozenset(
    {"sort", "pop", "append", "remove", "insert", "extend", "clear"}
)


class CacheInvalidationRule(Rule):
    id = "cache-invalidation"
    summary = (
        "mutations of relax/preference pod state must pair with _ktpu_* "
        "class-key invalidation (the relax invariant)"
    )
    targets = (
        "karpenter_tpu_torch/solver/oracle.py",
        "karpenter_tpu_torch/solver/tpu_problem.py",
    )

    def check(self, ctx: FileContext) -> list[Finding]:
        out = []
        # regions that handle invalidation: a class or function whose
        # source mentions the cache attrs or the invalidator
        safe_spans: list[tuple[int, int]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(
                node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                seg = ctx.segment(node)
                if "_ktpu_" in seg or "_invalidate_class_caches" in seg:
                    safe_spans.append((node.lineno, node.end_lineno or node.lineno))

        def safe(n: ast.AST) -> bool:
            return any(lo <= n.lineno <= hi for lo, hi in safe_spans)

        for node in ast.walk(ctx.tree):
            attr = self._sensitive_mutation(node)
            if attr and not safe(node):
                out.append(
                    ctx.finding(
                        self.id,
                        node,
                        f"mutation of relax-sensitive field `{attr}` with "
                        "no _ktpu_* cache invalidation in scope; the "
                        "encoder would dedup the pod into its stale class "
                        "(Preferences._invalidate_class_caches)",
                    )
                )
        return out

    @staticmethod
    def _sensitive_mutation(node: ast.AST) -> str:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Subscript):
                    t = t.value
                if isinstance(t, ast.Attribute) and t.attr in _SENSITIVE:
                    return t.attr
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _LIST_MUTATORS:
                v = node.func.value
                if isinstance(v, ast.Attribute) and v.attr in _SENSITIVE:
                    return v.attr
        return ""


RULES = (LockDisciplineRule, CacheInvalidationRule)
