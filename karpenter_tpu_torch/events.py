"""Dedup'd event recorder (reference pkg/events/recorder.go:30-104); a copy
of the JAX package's `events.py`, which imports only the standard library.

Controllers publish human-facing events about objects (pod nominated, claim
launched, disruption blocked...). Duplicate events within the dedupe TTL are
dropped so hot reconcile loops don't flood the stream — same contract as the
reference's rate-limited recorder (default 2-minute window, 10 events/sec
per reason bucket)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Event:
    kind: str  # involved object kind ("Pod", "NodeClaim", ...)
    name: str  # involved object name
    type: str  # "Normal" | "Warning"
    reason: str
    message: str
    # extra values participating in the dedupe key (reference
    # events.Event.DedupeValues)
    dedupe_values: tuple = ()

    def dedupe_key(self) -> tuple:
        # the message participates so a NEW failure cause within the TTL is
        # never swallowed; dedupe_values narrow the key further when set
        return (self.kind, self.name, self.reason, self.message, *self.dedupe_values)


class Recorder:
    def __init__(self, clock, dedupe_ttl_seconds: float = 120.0):
        self.clock = clock
        self.ttl = dedupe_ttl_seconds
        self.events: list[Event] = []
        self._last_seen: dict[tuple, float] = {}

    def publish(self, *events: Event) -> None:
        now = self.clock.now()
        for e in events:
            key = e.dedupe_key()
            last = self._last_seen.get(key)
            if last is not None and now - last < self.ttl:
                continue
            self._last_seen[key] = now
            self.events.append(e)

    def for_reason(self, reason: str) -> list[Event]:
        return [e for e in self.events if e.reason == reason]

    def reset(self) -> None:
        self.events.clear()
        self._last_seen.clear()


class NoopRecorder(Recorder):
    def __init__(self):
        class _Z:
            def now(self):
                return 0.0

        super().__init__(_Z())

    def publish(self, *events: Event) -> None:
        pass
