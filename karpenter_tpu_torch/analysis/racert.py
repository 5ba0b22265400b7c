"""graftlint race tier, runtime half: a tsan-lite lock witness.

A copy of the reference's `analysis/racert.py` for the port. The static
half (analysis/locks.py) proves what it can from source; this module
witnesses the rest at runtime, the way ThreadSanitizer's happens-before
machinery does — but scoped to what a test or a chip run can afford:

- `instrument()` replaces `threading.Lock`, `threading.RLock` and
  `threading.Condition` with factories returning thin instrumented
  wrappers. Every lock CREATED while instrumented reports its acquire/
  release to a process-global `Witness`; locks created before stay raw
  (their wrappers also go quiet again after `uninstrument()`).
- The witness keeps a per-thread stack of held locks. Acquiring B while
  holding A records the ordered pair (A, B), keyed by each lock's
  CREATION SITE (file:line) — the Eraser-style move that makes "the
  SolverServer stats lock" one identity across every server instance.
  Observing both (A, B) and (B, A) is a lock-order inversion: a
  deadlock that has not fired yet only because the two threads have not
  interleaved unluckily. Both acquisition stacks are captured so the
  report shows each side of the inversion.
- Holds longer than `hold_ms` are recorded (`long_holds`) — the runtime
  analog of the static `race-blocking-hold` rule.
- `threading.excepthook` is chained so background-thread exceptions are
  captured (`thread_exceptions`) instead of vanishing into stderr.

The port's service and resilient tests run under it, and chip_smoke.py's
sidecar phase turns it on around the card's server:
`Witness.assert_no_inversions()` fails with both stacks when an inversion
was observed.

Stack capture is a raw frame walk (no traceback formatting) so the
per-acquire overhead stays in the microseconds.

Pure stdlib — importing this module never pulls in torch, numpy or JAX.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Optional

# the raw primitives, captured before any patching so the witness's own
# synchronization and the restore path never recurse through wrappers
_RAW_LOCK = threading.Lock
_RAW_RLOCK = threading.RLock
_RAW_CONDITION = threading.Condition

_WITNESS: Optional["Witness"] = None
_SAVED: Optional[tuple] = None

_STACK_LIMIT = 8


def _callsite(depth: int) -> str:
    f = sys._getframe(depth)
    return f"{_shorten(f.f_code.co_filename)}:{f.f_lineno}"


# Resolved ONCE: sites double as report identities, so the prefix must
# not move underneath them — a test chdir-ing mid-run would otherwise
# split one lock role into two identities and edges over the halves
# could never pair up into an inversion. Also keeps the per-acquire
# frame walk syscall-free (up to _STACK_LIMIT+1 _shorten calls each).
_PREFIX = os.getcwd() + os.sep


def _shorten(path: str) -> str:
    # repo-relative when possible: sites double as report identities
    if path.startswith(_PREFIX):
        return path[len(_PREFIX) :]
    return path


_THIS_FILE = __file__


def _stack(skip: int) -> tuple[str, ...]:
    """Cheap acquisition stack: (file:line in func, ...) innermost first,
    skipping the wrapper frames. No format_stack — a faults solve takes
    thousands of lock ops and formatting would dominate the test."""
    out = []
    try:
        f: Any = sys._getframe(skip)
    except ValueError:
        return ()
    # a `with lock:` adds an __enter__ frame the fixed skip cannot see;
    # the report must lead with the USER frame, not wrapper noise (which
    # would also burn one of the _STACK_LIMIT slots)
    while f is not None and f.f_code.co_filename == _THIS_FILE:
        f = f.f_back
    while f is not None and len(out) < _STACK_LIMIT:
        co = f.f_code
        out.append(f"{_shorten(co.co_filename)}:{f.f_lineno} in {co.co_name}")
        f = f.f_back
    return tuple(out)


class Witness:
    """Process-global race evidence: acquisition-order edges, observed
    inversions, long holds, background-thread exceptions."""

    def __init__(self, hold_ms: float = 250.0):
        self.hold_ms = hold_ms
        self._mu = _RAW_LOCK()
        self._tls = threading.local()
        # (held_site, acquired_site) -> first-observation record
        self.edges: dict[tuple[str, str], dict] = {}
        self.inversions: list[dict] = []
        self._inverted: set[frozenset] = set()
        self.long_holds: list[dict] = []
        self.thread_exceptions: list[dict] = []
        # per-thread count cells, registered once per thread (under _mu)
        # and bumped lock-free after that: the no-held fast path must not
        # funnel every lock op in the program through one global mutex —
        # that contention would perturb exactly the interleavings the
        # witness exists to observe
        self._count_cells: list[list[int]] = []

    @property
    def acquire_count(self) -> int:
        with self._mu:
            return sum(c[0] for c in self._count_cells)

    # -- wrapper callbacks --------------------------------------------------

    def _held(self) -> list[dict]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
            cell = self._tls.count = [0]
            with self._mu:
                self._count_cells.append(cell)
        return held

    def on_acquire(self, lock: "_LockBase") -> None:
        held = self._held()
        for entry in held:
            if entry["lock"] is lock:
                entry["depth"] += 1  # reentrant re-acquire: no new edge
                return
        stack = _stack(3)
        entry = {
            "lock": lock,
            "site": lock._racert_site,
            "t0": time.monotonic(),
            "depth": 1,
            "stack": stack,
        }
        self._tls.count[0] += 1  # own cell: no lock, no cross-thread race
        if held:
            with self._mu:
                for h in held:
                    a, b = h["site"], lock._racert_site
                    if a == b:
                        continue
                    key = (a, b)
                    rec = self.edges.get(key)
                    if rec is None:
                        self.edges[key] = {
                            "count": 1,
                            "held_stack": h["stack"],
                            "acquire_stack": stack,
                            "thread": threading.current_thread().name,
                        }
                    else:
                        rec["count"] += 1
                    other = self.edges.get((b, a))
                    pair = frozenset(key)
                    if other is not None and pair not in self._inverted:
                        self._inverted.add(pair)
                        mine = self.edges[key]
                        self.inversions.append(
                            {
                                "locks": (a, b),
                                "order_a_then_b": {
                                    "thread": mine["thread"],
                                    "holding": a,
                                    "acquiring": b,
                                    "stack": mine["acquire_stack"],
                                },
                                "order_b_then_a": {
                                    "thread": other["thread"],
                                    "holding": b,
                                    "acquiring": a,
                                    "stack": other["acquire_stack"],
                                },
                            }
                        )
        held.append(entry)

    def _finish_hold(self, entry: dict) -> None:
        ms = (time.monotonic() - entry["t0"]) * 1000.0
        if ms > self.hold_ms:
            with self._mu:
                self.long_holds.append(
                    {
                        "site": entry["site"],
                        "held_ms": round(ms, 1),
                        "stack": entry["stack"],
                        "thread": threading.current_thread().name,
                    }
                )

    def on_release(self, lock: "_LockBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i]["lock"] is lock:
                held[i]["depth"] -= 1
                if held[i]["depth"] == 0:
                    self._finish_hold(held.pop(i))
                return
        # release of a hold this witness never saw (acquired before
        # instrument(), or Condition.wait internals): not our evidence

    def on_release_save(self, lock: "_LockBase") -> int:
        """Condition.wait dropping EVERY recursion level at once: pop the
        entry whole (the raw `_release_save` fully releases, so tracking
        it as still held would report the entire blocked wait as a hold —
        a spurious long_hold, and phantom edges for anything acquired
        while 'holding' it). Returns the depth to re-establish after the
        wait, 0 when this witness never saw the hold."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i]["lock"] is lock:
                entry = held.pop(i)
                self._finish_hold(entry)
                return entry["depth"]
        return 0

    def on_acquire_restore(self, lock: "_LockBase", depth: int) -> None:
        """The wake side of on_release_save: one fresh acquisition (fresh
        t0 — the wait was not a hold) restored to the saved depth."""
        self.on_acquire(lock)
        held = self._held()
        for entry in reversed(held):
            if entry["lock"] is lock:
                entry["depth"] = depth
                return

    def on_thread_exception(self, args) -> None:
        with self._mu:
            self.thread_exceptions.append(
                {
                    "thread": getattr(args.thread, "name", "?"),
                    "exc_type": getattr(args.exc_type, "__name__", "?"),
                    "exc": str(args.exc_value),
                }
            )

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            return {
                # not via the acquire_count property: it takes _mu too
                "acquires": sum(c[0] for c in self._count_cells),
                "edges": {
                    f"{a} -> {b}": rec["count"]
                    for (a, b), rec in sorted(self.edges.items())
                },
                "inversions": list(self.inversions),
                "long_holds": list(self.long_holds),
                "thread_exceptions": list(self.thread_exceptions),
            }

    @staticmethod
    def _render_side(side: dict) -> str:
        head = (
            f"    [{side['thread']}] holding {side['holding']}, "
            f"acquiring {side['acquiring']}:"
        )
        frames = "".join(f"\n      {fr}" for fr in side["stack"])
        return head + frames

    def render_inversions(self) -> str:
        parts = []
        for inv in self.inversions:
            a, b = inv["locks"]
            parts.append(
                f"lock-order inversion between {a} and {b}:\n"
                + self._render_side(inv["order_a_then_b"])
                + "\n"
                + self._render_side(inv["order_b_then_a"])
            )
        return "\n".join(parts)

    def assert_no_inversions(self) -> None:
        if self.inversions:
            raise AssertionError(
                f"racert witnessed {len(self.inversions)} lock-order "
                "inversion(s) — a deadlock waiting for the right "
                "interleaving:\n" + self.render_inversions()
            )

    def assert_no_thread_exceptions(self) -> None:
        if self.thread_exceptions:
            lines = "\n".join(
                f"  [{e['thread']}] {e['exc_type']}: {e['exc']}"
                for e in self.thread_exceptions
            )
            raise AssertionError(
                f"racert captured {len(self.thread_exceptions)} uncaught "
                "background-thread exception(s):\n" + lines
            )


# ---------------------------------------------------------------------------
# instrumented wrappers


class _LockBase:
    """Shared wrapper plumbing. Wrappers outlive uninstrument(): every
    callback goes through the CURRENT module-global witness and becomes a
    no-op when none is installed, so a lock created during one
    instrumented test is inert in the next."""

    _racert_kind = "Lock"

    def __init__(self, raw, site: str):
        self._raw = raw
        self._racert_site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._raw.acquire(blocking, timeout)
        if got:
            w = _WITNESS
            if w is not None:
                w.on_acquire(self)
        return got

    def release(self) -> None:
        w = _WITNESS
        if w is not None:
            w.on_release(self)
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        # _thread.RLock grows .locked() only in 3.14 — the wrapper must
        # not invent API the raw lock lacks, or code works uninstrumented
        # and crashes only inside racert-marked tests
        fn = getattr(self._raw, "locked", None)
        if fn is None:
            raise AttributeError(
                f"{type(self._raw).__name__!r} object has no attribute "
                "'locked' on this Python version"
            )
        return fn()

    def _at_fork_reinit(self) -> None:
        # stdlib modules register lock._at_fork_reinit with os.register_
        # at_fork at IMPORT time (concurrent.futures.thread does, via its
        # global shutdown lock) — a module first imported inside an
        # instrumented test must get the real reinit hook, not an
        # AttributeError (found by the epoch chaos soak, whose Operator
        # import pulled in ThreadPoolExecutor under instrumentation)
        self._raw._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<racert {self._racert_kind} from {self._racert_site}>"


class _InstrumentedLock(_LockBase):
    _racert_kind = "Lock"


class _InstrumentedRLock(_LockBase):
    _racert_kind = "RLock"

    # threading.Condition over an RLock uses these to drop every
    # recursion level around wait(); the witness must drop ALL levels too
    # (on_release_save), not just one, or a re-entrantly held RLock stays
    # "held" for the whole wait. Condition treats the saved state as
    # opaque, so the wrapper piggybacks the witnessed depth on it.
    def _release_save(self):
        w = _WITNESS
        depth = w.on_release_save(self) if w is not None else 0
        return (self._raw._release_save(), depth)

    def _acquire_restore(self, state) -> None:
        raw_state, depth = state
        self._raw._acquire_restore(raw_state)
        w = _WITNESS
        if w is not None and depth:
            w.on_acquire_restore(self, depth)

    def _is_owned(self) -> bool:
        return self._raw._is_owned()


def _lock_factory():
    return _InstrumentedLock(_RAW_LOCK(), _callsite(2))


def _rlock_factory():
    return _InstrumentedRLock(_RAW_RLOCK(), _callsite(2))


def _condition_factory(lock=None):
    # a real Condition over an instrumented lock: Condition's own
    # acquire/release/wait delegate to the wrapper (via _release_save /
    # _acquire_restore for RLocks, plain release/acquire for Locks), so
    # every hold is still witnessed
    if lock is None:
        lock = _InstrumentedRLock(_RAW_RLOCK(), _callsite(2))
    return _RAW_CONDITION(lock)


# ---------------------------------------------------------------------------
# install / remove


def instrument(hold_ms: float = 250.0) -> Witness:
    """Patch threading's lock constructors and excepthook; returns the
    fresh process-global Witness. Re-entrant calls return the existing
    witness (one harness owns the patch at a time)."""
    global _WITNESS, _SAVED
    if _WITNESS is not None:
        return _WITNESS
    _WITNESS = Witness(hold_ms=hold_ms)
    _SAVED = (
        threading.Lock,
        threading.RLock,
        threading.Condition,
        threading.excepthook,
    )
    def _hook(args):
        # the witness is the loud path (the conftest fixture asserts on
        # it at teardown); the previous hook is NOT chained, so the same
        # exception is not double-reported through pytest's
        # threadexception warning on top of the witness failure
        w = _WITNESS
        if w is not None:
            w.on_thread_exception(args)

    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    threading.excepthook = _hook
    return _WITNESS


def uninstrument() -> Optional[Witness]:
    """Restore threading's constructors; returns the retired witness.
    Wrappers already handed out stay functional but stop reporting."""
    global _WITNESS, _SAVED
    witness = _WITNESS
    if _SAVED is not None:
        (
            threading.Lock,
            threading.RLock,
            threading.Condition,
            threading.excepthook,
        ) = _SAVED
        _SAVED = None
    _WITNESS = None
    return witness


def current() -> Optional[Witness]:
    return _WITNESS
