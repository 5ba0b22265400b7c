"""Prometheus-style metrics registry (reference pkg/metrics/
metrics.go:32-99, constants.go:42-67, store.go:33-110); a copy of the JAX
package's `metrics.py`, which imports only the standard library.

Namespace `karpenter`, counters/gauges/histograms keyed by label tuples, a
`measure()` context manager mirroring the reference's defer-timer, and a
keyed gauge Store for metric garbage collection (a gauge family whose stale
series vanish when the backing object does). Exposition via render()."""

from __future__ import annotations

import threading

import math
import time
from contextlib import contextmanager
from typing import Iterable, Optional

NAMESPACE = "karpenter"

# reference pkg/metrics/constants.go:42 DurationBuckets
DURATION_BUCKETS = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300,
]


class Metric:
    def __init__(self, name: str, help: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = label_names

    def _key(self, labels: dict[str, str]) -> tuple:
        return tuple(labels.get(k, "") for k in self.label_names)


class Counter(Metric):
    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, tuple(label_names))
        self.values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Optional[dict] = None, by: float = 1.0) -> None:
        k = self._key(labels or {})
        # controllers may run on worker pools (utils/workerpool.py); the
        # read-modify-write must not lose increments under preemption
        with self._lock:
            self.values[k] = self.values.get(k, 0.0) + by

    def value(self, labels: Optional[dict] = None) -> float:
        with self._lock:
            return self.values.get(self._key(labels or {}), 0.0)


class Gauge(Metric):
    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, tuple(label_names))
        self.values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[dict] = None) -> None:
        with self._lock:
            self.values[self._key(labels or {})] = value

    def add(self, by: float, labels: Optional[dict] = None) -> None:
        k = self._key(labels or {})
        with self._lock:
            self.values[k] = self.values.get(k, 0.0) + by

    def value(self, labels: Optional[dict] = None) -> float:
        with self._lock:
            return self.values.get(self._key(labels or {}), 0.0)

    def delete(self, labels: dict) -> None:
        with self._lock:
            self.values.pop(self._key(labels), None)


class Histogram(Metric):
    def __init__(self, name, help, label_names=(), buckets=None):
        super().__init__(name, help, tuple(label_names))
        self.buckets = list(buckets or DURATION_BUCKETS)
        self.counts: dict[tuple, list[int]] = {}
        self.sums: dict[tuple, float] = {}
        self.totals: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[dict] = None) -> None:
        k = self._key(labels or {})
        with self._lock:
            if k not in self.counts:
                self.counts[k] = [0] * len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[k][i] += 1
            self.sums[k] = self.sums.get(k, 0.0) + value
            self.totals[k] = self.totals.get(k, 0) + 1

    def count(self, labels: Optional[dict] = None) -> int:
        with self._lock:
            return self.totals.get(self._key(labels or {}), 0)

    def sum(self, labels: Optional[dict] = None) -> float:
        with self._lock:
            return self.sums.get(self._key(labels or {}), 0.0)

    def snapshot(self) -> tuple[dict, dict, dict]:
        """Consistent (counts, sums, totals) copy for exposition: a
        /metrics scrape racing a worker-pool observe must not see a torn
        histogram (bucket/sum/count mismatch) or a dict mutated during
        iteration."""
        with self._lock:
            return (
                {k: list(v) for k, v in self.counts.items()},
                dict(self.sums),
                dict(self.totals),
            )

    @contextmanager
    def measure(self, labels: Optional[dict] = None):
        """metrics.Measure defer-timer (constants.go:63)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.observe(time.monotonic() - t0, labels)


class Store:
    """Keyed gauge store for metric GC (reference store.go:33): update(key)
    replaces the series owned by that key; delete(key) removes them."""

    def __init__(self, gauge: Gauge):
        self.gauge = gauge
        self._owned: dict[str, list[dict]] = {}
        # controllers updating the same store may run on worker pools;
        # two racing update(key) calls must not interleave delete/set and
        # leak orphaned series. Lock order store -> gauge, never inverse.
        self._lock = threading.Lock()

    def update(self, key: str, series: list[tuple[dict, float]]) -> None:
        with self._lock:
            self._delete_locked(key)
            owned = []
            for labels, value in series:
                self.gauge.set(value, labels)
                owned.append(labels)
            self._owned[key] = owned

    def delete(self, key: str) -> None:
        with self._lock:
            self._delete_locked(key)

    def _delete_locked(self, key: str) -> None:
        for labels in self._owned.pop(key, []):
            self.gauge.delete(labels)


def _escape_help(text: str) -> str:
    """Prometheus text-format HELP escaping: backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, quote,
    newline — an unescaped quote or newline in a label (a fallback reason,
    an error string) would corrupt the whole exposition."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class Registry:
    def __init__(self):
        self.metrics: dict[str, Metric] = {}
        # registration mostly happens at import, but late registrations
        # (test fixtures, lazily-built controllers) can race a /metrics
        # scrape iterating the dict
        self._lock = threading.Lock()

    def counter(self, name, help, label_names=()) -> Counter:
        return self._register(Counter(name, help, label_names))

    def gauge(self, name, help, label_names=()) -> Gauge:
        return self._register(Gauge(name, help, label_names))

    def histogram(self, name, help, label_names=(), buckets=None) -> Histogram:
        return self._register(Histogram(name, help, label_names, buckets))

    def _register(self, m):
        with self._lock:
            existing = self.metrics.get(m.name)
            if existing is not None:
                return existing
            self.metrics[m.name] = m
            return m

    def render(self) -> str:
        """Prometheus text exposition."""
        lines = []
        with self._lock:
            snapshot = list(self.metrics.values())
        for m in snapshot:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            kind = (
                "counter"
                if isinstance(m, Counter)
                else "histogram"
                if isinstance(m, Histogram)
                else "gauge"
            )
            lines.append(f"# TYPE {m.name} {kind}")

            def fmt(key):
                if not m.label_names:
                    return ""
                pairs = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(m.label_names, key)
                )
                return "{" + pairs + "}"

            if isinstance(m, Histogram):
                counts_s, sums_s, totals_s = m.snapshot()
                for k, counts in counts_s.items():
                    base = [
                        f'{n}="{_escape_label(v)}"'
                        for n, v in zip(m.label_names, k)
                    ]
                    for b, c in zip(m.buckets, counts):
                        pairs = ",".join(base + [f'le="{b}"'])
                        lines.append(f"{m.name}_bucket{{{pairs}}} {c}")
                    inf_pairs = ",".join(base + ['le="+Inf"'])
                    lines.append(f"{m.name}_bucket{{{inf_pairs}}} {totals_s[k]}")
                    lines.append(f"{m.name}_sum{fmt(k)} {sums_s[k]}")
                    lines.append(f"{m.name}_count{fmt(k)} {totals_s[k]}")
            else:
                with m._lock:
                    values_s = dict(m.values)
                for k, v in values_s.items():
                    lines.append(f"{m.name}{fmt(k)} {v}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self.metrics.clear()


REGISTRY = Registry()


def reset() -> None:
    REGISTRY.reset()
