"""Structured logging: the zap-equivalent for this framework (a copy of the
JAX package's `logging.py`, which imports only the standard library).

Reference pkg/operator/logging/logging.go: the operator
builds a zap JSON logger (level-gated, named per controller, structured
key/value fields) and every controller logs its decisions through it. Here
the same shape rides the stdlib: one process-wide `Logger` producing one
JSON object per line with `ts`, `level`, `logger` (controller name), `msg`,
and arbitrary structured fields — machine-parseable like the reference's
zap output, silent below the configured level, and capturable in tests via
`capture()`.

Controllers obtain named children with `logger.named("provisioner")`, the
analog of zap's Named(); the Operator wires the level from Options
(`log_level`, env KARPENTER_LOG_LEVEL).
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_ALIASES = {"warning": "warn", "err": "error"}


def _level_no(level: str) -> int:
    name = str(level).lower()
    name = _ALIASES.get(name, name)
    return LEVELS.get(name, 20)


class Logger:
    """A named, level-gated JSON-lines logger."""

    def __init__(
        self,
        name: str = "",
        level: str = "info",
        stream=None,
        clock=None,
        _root: Optional["Logger"] = None,
    ):
        self.name = name
        self._root = _root or self
        if _root is None:
            self._level_no = _level_no(level)
            self._stream = stream or sys.stderr
            self._lock = threading.Lock()
            self._clock = clock
            self._capturing = False

    # -- configuration (root only) ---------------------------------------

    def set_level(self, level: str) -> None:
        # capture() pins the level for the duration of the capture so an
        # Operator constructed inside the block can't silently defeat it
        if getattr(self._root, "_capturing", False):
            return
        self._root._level_no = _level_no(level)

    def set_clock(self, clock) -> None:
        """Use a simulation clock for timestamps (tests, FakeClock)."""
        self._root._clock = clock

    def named(self, name: str) -> "Logger":
        """zap Named(): a child whose records carry `parent.child`."""
        child = Logger(_root=self._root)
        child.name = f"{self.name}.{name}" if self.name else name
        return child

    # -- emission ---------------------------------------------------------

    def _emit(self, level: str, msg: str, fields: dict[str, Any]) -> None:
        root = self._root
        if LEVELS[level] < root._level_no:
            return
        now = root._clock.now() if root._clock is not None else time.time()
        rec = {"ts": round(now, 3), "level": level, "logger": self.name, "msg": msg}
        for k, v in fields.items():
            rec[k] = v if isinstance(v, (str, int, float, bool, type(None))) else str(v)
        line = json.dumps(rec, separators=(",", ":"))
        with root._lock:
            print(line, file=root._stream, flush=False)

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit("info", msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._emit("warn", msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._emit("error", msg, fields)


# the process-wide root, like the reference's injected context logger
root = Logger(name="karpenter")


@contextmanager
def capture(level: str = "debug"):
    """Route the root logger into a buffer and yield the parsed records —
    the test harness for controller logging.

    Also hooks `threading.excepthook` for the duration: an uncaught
    exception in a background thread (a server connection handler dying,
    a worker-pool task exploding outside its catch) becomes an ERROR
    record named `karpenter.threading` AND lands in
    `records.thread_exceptions`, so a test can assert on it — instead of
    the default behavior, where the traceback prints to the real stderr
    and the test passes in silence."""
    buf = io.StringIO()
    old_stream, old_level = root._stream, root._level_no
    old_clock = root._clock
    root._stream = buf
    root._level_no = _level_no(level)
    root._capturing = True
    old_hook = threading.excepthook
    thread_exceptions: list[dict] = []
    thread_log = root.named("threading")

    def _thread_hook(args):
        info = {
            "thread": getattr(args.thread, "name", "?"),
            "exc_type": getattr(args.exc_type, "__name__", "?"),
            "exc_value": args.exc_value,
        }
        thread_exceptions.append(info)
        thread_log.error(
            "uncaught exception in background thread",
            thread=info["thread"],
            error=f"{info['exc_type']}: {info['exc_value']}",
        )
        # CHAIN the previous hook: recording the exception must not hide
        # it from an outer hook (pytest's threadexception reporting, or
        # the stderr default).
        old_hook(args)

    threading.excepthook = _thread_hook

    class Records(list):
        def refresh(self):
            self.clear()
            for line in buf.getvalue().splitlines():
                if line.strip():
                    self.append(json.loads(line))
            return self

    records = Records()
    records.thread_exceptions = thread_exceptions
    try:
        yield records
    finally:
        records.refresh()
        threading.excepthook = old_hook
        root._stream = old_stream
        root._level_no = old_level
        root._clock = old_clock
        root._capturing = False
