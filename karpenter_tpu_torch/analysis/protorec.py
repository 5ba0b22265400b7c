"""protorec — the protocol tier's runtime trace recorder.

A copy of the reference's `analysis/protorec.py`. Thin hooks inside the
real wire and breaker code paths — SolverClient roundtrips and epoch
commits, SolverServer frame recv/send/close and epoch stores,
CircuitBreaker transitions (solver/service.py, solver/hybrid.py) — append
structured events to a process-global recorder while one is installed.
The port's `analysis.proto.check_refinement` (a copy of the reference's
judge) then verifies that the recorded trace is an accepted behavior of
the protocol model: the same acceptors that judge model-generated traces
judge this code's traces.

Off by default, and free when off: every hook site is
`if protorec.RECORDER is not None:` — one module-attribute load and an
identity test on the serving hot path. A test installs a recorder
(`install`), drives the boundary, and hands `RECORDER.snapshot()` to the
judge; chip_smoke.py's sidecar phase does the same on the card.
Stdlib-only.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

__all__ = ["TraceRecorder", "RECORDER", "install", "uninstall", "active"]


class TraceRecorder:
    """An append-only, thread-safe event log.

    Events are flat dicts; `record` stamps each with a monotonically
    increasing sequence number (`i`) and the recording thread's ident
    (`thread`) — the refinement acceptors in analysis/proto.py match
    per-thread protocol obligations (a claimed half-open probe must be
    resolved by the SAME thread's record_success/record_failure), so
    cross-thread interleaving of unrelated requests can never fake or
    mask a violation.

    Connection identity: sockets are recycled, so `id(conn)` alone can
    alias two streams. `conn_id` hands out dense ids through a live-map
    keyed on `id(conn)`; `conn_closed` pops the entry, so a recycled
    address gets a FRESH id and per-connection event streams stay
    disjoint.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._conn_ids: dict[int, int] = {}
        self._next_conn = 0

    def record(self, **event: Any) -> None:
        tid = threading.get_ident()
        with self._lock:
            event["i"] = len(self._events)
            event["thread"] = tid
            self._events.append(event)

    def conn_id(self, conn: Any) -> int:
        key = id(conn)
        with self._lock:
            cid = self._conn_ids.get(key)
            if cid is None:
                cid = self._next_conn
                self._next_conn += 1
                self._conn_ids[key] = cid
            return cid

    def conn_closed(self, conn: Any) -> int:
        """Return the connection's id and retire it (address may be
        recycled by a later socket)."""
        key = id(conn)
        with self._lock:
            cid = self._conn_ids.pop(key, None)
            if cid is None:
                cid = self._next_conn
                self._next_conn += 1
            return cid

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# The one global the hook sites poll. `None` means disabled — the hooks
# compile down to a LOAD_ATTR + identity test and fall through.
RECORDER: Optional[TraceRecorder] = None


def install() -> TraceRecorder:
    """Install (and return) a fresh global recorder. Idempotent per
    call: a second install replaces the first — each test gets its own
    event log."""
    global RECORDER
    rec = TraceRecorder()
    RECORDER = rec
    return rec


def uninstall() -> None:
    global RECORDER
    RECORDER = None


def active() -> Optional[TraceRecorder]:
    return RECORDER
