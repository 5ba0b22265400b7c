"""End-to-end solve telemetry: phase-span tracing from the controller to
the kernel drivers, wired through the sidecar protocol.

A copy of the reference's `tracing.py`: ONE trace follows a provisioning
round from `Provisioner.schedule` through `ResilientSolver`, the wire
client, the `SolverServer`, and the host phases of the solve driver
(encode / order / upload / dispatch / regrow / decode) plus the
consolidation sweep rounds (disruption/sweep.py, setsweep.py).

- **Explicit context objects, no contextvars.** A `Trace` is created at
  the top of a solve and passed DOWN the call chain as an ordinary
  argument. Every span is a host-side `time.monotonic()` pair around host
  code; a span around a kernel launch times the launch and the fetch
  that waits for it.
- **Wire correlation ids ARE trace ids.** The v2 frame header's req_id
  (solver/service.py) becomes the trace id on both sides of the socket
  (`Trace.set_wire_id`), so a client-side trace and the sidecar's
  server-side trace of the same solve join into one logical trace in the
  ring.
- **Bounded by construction.** Completed traces land in a fixed-capacity
  ring (`RING`); each trace caps its span list (`MAX_SPANS`) and beyond
  the cap only aggregates per-phase totals. Per-span *detail* (the
  pod_xs/kernel/fetch sub-phases of each dispatch) is recorded only
  behind the profiling gate (`set_detail`).

Every span also feeds the labeled metrics below, on the port's own
`metrics.REGISTRY`.

Left out: the reference's JAX compile listener (`install_compile_listener`,
`trace_events`) and its `karpenter_jax_compilation_events_total` counter.
They read JAX's monitoring events; the port's counterpart, a count of
kernel builds and launches per solve, is a launch-budget item of its own.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

from karpenter_tpu_torch import metrics

# -- solve telemetry metrics -------------------------------------------------

SOLVE_PHASE_SECONDS = metrics.REGISTRY.histogram(
    "karpenter_solve_phase_duration_seconds",
    "Wall-clock seconds per solve phase (one observation per phase per trace).",
    ("phase",),
)
SOLVE_DISPATCHES = metrics.REGISTRY.counter(
    "karpenter_solve_dispatches_total",
    "Device kernel dispatches, by path (runs/scan/sweep/setsweep, plus "
    "fleet = one coalesced lane launch per batch-window round).",
    ("path",),
)
SOLVE_REGROWS = metrics.REGISTRY.counter(
    "karpenter_solve_claim_regrows_total",
    "Mid-solve claim-slot pool growth events (runs-path overflow continuations).",
)
SOLVE_RELAX_TIERS = metrics.REGISTRY.counter(
    "karpenter_solve_relax_tiers_total",
    "Relaxation-ladder tiers beyond tier 0 carried by solve steps.",
)
SOLVE_UPLOAD_BYTES = metrics.REGISTRY.counter(
    "karpenter_solve_upload_bytes_total",
    "Host->device bytes uploaded for per-solve tables.",
)
SOLVE_FALLBACKS = metrics.REGISTRY.counter(
    "karpenter_solve_oracle_fallback_total",
    "Solves (or solve partitions) that ran on the oracle, by reason.",
    ("reason",),
)
SOLVE_TRACES = metrics.REGISTRY.counter(
    "karpenter_solve_traces_total",
    "Completed solve traces, by kind and outcome.",
    ("kind", "outcome"),
)
SWEEP_SET_LANES = metrics.REGISTRY.counter(
    "karpenter_sweep_set_lanes_total",
    "Removal-set lanes evaluated by consolidation sweep dispatches.",
)

# -- kernel odometers (device-truth counters returned by each dispatch) ------

KERNEL_ITERATIONS = metrics.REGISTRY.counter(
    "karpenter_kernel_iterations_total",
    "Device loop iterations executed inside kernel dispatches, by path "
    "(runs/scan while-loop and scan steps, fleet = per-lane scan steps, "
    "sweep/setsweep class-scan trips) — the odometer wave packing must "
    "shrink.",
    ("path",),
)
KERNEL_TIER_STEPS = metrics.REGISTRY.counter(
    "karpenter_kernel_relax_tier_steps_total",
    "Relax tier-loop body trips by tier index (each trip runs one full "
    "kernel step; tier 7 aggregates deeper rungs).",
    ("tier",),
)
KERNEL_CLAIMS_OPENED = metrics.REGISTRY.counter(
    "karpenter_kernel_claims_opened_total",
    "Fresh claim slots the kernel committed (device n_claims at decode).",
)
KERNEL_CLAIM_OCCUPANCY = metrics.REGISTRY.histogram(
    "karpenter_kernel_claim_slot_occupancy",
    "High-water claim-slot occupancy per solve (n_claims / padded slot "
    "pool N after any regrows) — how tight claim_slot_div started.",
    buckets=[0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
)
KERNEL_OVERFLOWS = metrics.REGISTRY.counter(
    "karpenter_kernel_overflow_signals_total",
    "Claim-slot overflow signals returned by kernel dispatches, by path "
    "(runs: pad-and-continue regrow; scan: full re-solve at 2N).",
    ("path",),
)

# spans recorded per trace before degrading to aggregate-only totals
MAX_SPANS = 256
# completed traces retained for /debug/solves
RING_CAPACITY = 128

RING_TRACES = metrics.REGISTRY.gauge(
    "karpenter_trace_ring_traces",
    "Completed traces currently held by the /debug/solves ring "
    "(capacity RING_CAPACITY=128; pegged at capacity = oldest traces "
    "are being evicted).",
)

# profiling gate: when off, detail=True spans fold into the per-phase
# totals without an individual Span entry
_DETAIL = False


def set_detail(on: bool) -> None:
    global _DETAIL
    _DETAIL = bool(on)


def detail_enabled() -> bool:
    return _DETAIL


class Span:
    """One timed phase inside a trace. `t0` is seconds since trace start;
    `depth` is the nesting level at entry (0 = top-level phase)."""

    __slots__ = ("name", "t0", "dur", "depth", "attrs")

    def __init__(self, name: str, t0: float, dur: float, depth: int, attrs: dict):
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.depth = depth
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "t0": round(self.t0, 6),
            "seconds": round(self.dur, 6),
            "depth": self.depth,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


_seq_lock = threading.Lock()
_seq = [0]


def _next_seq() -> int:
    with _seq_lock:
        _seq[0] += 1
        return _seq[0]


class Trace:
    """One solve's span record. NOT thread-safe by design: a trace belongs
    to the single thread driving its solve (server handler threads each
    own their trace); only the finished ring is shared."""

    def __init__(self, kind: str, side: str = "local", trace_id: Optional[str] = None):
        self.kind = kind
        self.side = side
        self.seq = _next_seq()
        self.trace_id = trace_id or f"t{self.seq}"
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.attrs: dict[str, Any] = {}
        self.outcome: Optional[str] = None
        self.total_seconds = 0.0
        self.truncated = False
        # per-phase totals: name -> [seconds, min depth seen]
        self._phase_totals: dict[str, list] = {}
        self._depth = 0

    # -- recording -------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, detail: bool = False, **attrs: Any) -> Iterator[dict]:
        """Time the enclosed block as a phase. detail=True spans (the
        per-dispatch pod_xs/kernel/fetch sub-phases) still accumulate in
        the phase totals but only get an individual Span entry when the
        profiling gate is on.

        Yields the span's (mutable) attrs dict, so blocks whose facts
        only exist at exit can attach them — the dispatch spans put the
        fetched kernel-odometer block here (`attrs["kernel"] = {...}`)
        and the /debug/solves waterfall shows device work per dispatch,
        not just host wall-clock."""
        attrs = dict(attrs)
        depth = self._depth
        self._depth = depth + 1
        start = time.monotonic()
        try:
            yield attrs
        finally:
            self._depth = depth
            dur = time.monotonic() - start
            tot = self._phase_totals.setdefault(name, [0.0, depth])
            tot[0] += dur
            tot[1] = min(tot[1], depth)
            if (not detail) or _DETAIL:
                if len(self.spans) < MAX_SPANS:
                    self.spans.append(
                        Span(name, start - self._t0, dur, depth, attrs)
                    )
                else:
                    self.truncated = True

    def event(self, name: str, **attrs: Any) -> None:
        """A zero-duration marker span (e.g. an oracle-fallback reason)."""
        if len(self.spans) < MAX_SPANS:
            self.spans.append(
                Span(name, time.monotonic() - self._t0, 0.0, self._depth, dict(attrs))
            )
        else:
            self.truncated = True

    def count(self, name: str, by: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + by

    def annotate(self, **kw: Any) -> None:
        self.attrs.update(kw)

    def set_wire_id(self, req_id: int) -> None:
        """Adopt the v2 frame correlation id as the trace id, joining this
        trace with its peer across the sidecar socket."""
        self.trace_id = f"w{int(req_id)}"

    # -- completion ------------------------------------------------------

    def finish(self, outcome: str = "ok") -> None:
        """Idempotent: push to the ring and emit the per-phase histogram
        observations (aggregated — one observe per phase name, not per
        span, so metric cost is bounded by the phase vocabulary).

        outcome="unsupported" marks expected ladder control flow (a sweep
        gate raising SweepUnsupported on every reconcile of a gated
        fleet): counted in the traces metric, but kept OUT of the ring so
        a permanently-gated fleet cannot crowd real solve traces out of
        /debug/solves."""
        if self.outcome is not None:
            return
        self.outcome = outcome
        self.total_seconds = time.monotonic() - self._t0
        # spans append at EXIT (children before parents); the waterfall
        # reads start-ordered
        self.spans.sort(key=lambda s: (s.t0, s.depth))
        if outcome != "unsupported":
            RING.push(self)
        for name, (secs, _depth) in self._phase_totals.items():
            SOLVE_PHASE_SECONDS.observe(secs, {"phase": name})
        SOLVE_TRACES.inc({"kind": self.kind, "outcome": outcome})

    # -- introspection ---------------------------------------------------

    @property
    def phases(self) -> dict[str, float]:
        """Per-phase wall-clock totals (every name, including nested
        sub-phases — nested names overlap their parents, so do not sum
        this dict; see top_phases)."""
        return {k: v[0] for k, v in self._phase_totals.items()}

    def top_phases(self) -> dict[str, float]:
        """Totals for depth-0 phases only — disjoint spans that partition
        the solve (encode/order/upload/dispatch/regrow/decode for a
        kernel solve); safe to sum for share-of-solve breakdowns."""
        return {k: v[0] for k, v in self._phase_totals.items() if v[1] == 0}

    def to_dict(self, summary: bool = False) -> dict:
        d = {
            "id": self.trace_id,
            "seq": self.seq,
            "kind": self.kind,
            "side": self.side,
            "started_at": self.started_at,
            "total_seconds": round(self.total_seconds, 6),
            "outcome": self.outcome,
            "attrs": dict(self.attrs),
            "counts": dict(self.counts),
            "truncated": self.truncated,
        }
        if not summary:
            d["phases"] = {k: round(v, 6) for k, v in self.phases.items()}
            d["spans"] = [s.to_dict() for s in self.spans]
        return d

    def render(self) -> str:
        """Phase table, largest first (SolveProfile.render analog)."""
        total = self.total_seconds or sum(self.top_phases().values()) or 1.0
        return "\n".join(
            f"{name:12s} {dt:8.3f}s {100.0 * dt / total:5.1f}%"
            for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1])
        )


class TraceRing:
    """Bounded ring of completed traces, newest last. The only shared
    telemetry structure: pushes come from solver/handler threads while
    /debug/solves snapshots concurrently, so membership mutates under a
    lock (metric observes happen outside it — the ring lock is a leaf in
    the program's lock graph, same discipline as SolverServer's)."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._items: deque[Trace] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def push(self, trace: Trace) -> None:
        with self._lock:
            self._items.append(trace)
            n = len(self._items)
        # observe outside the lock (leaf-lock discipline, class docstring)
        RING_TRACES.set(float(n))

    def snapshot(self) -> list[Trace]:
        with self._lock:
            return list(self._items)

    def find(self, ident: str) -> list[Trace]:
        """Traces whose trace_id or seq matches `ident` — a wire id may
        match one client-side and one server-side trace (that pair IS the
        joined trace)."""
        with self._lock:
            return [
                t
                for t in self._items
                if t.trace_id == ident or str(t.seq) == ident
            ]

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
        RING_TRACES.set(0.0)


RING = TraceRing()


def new_trace(kind: str, side: str = "local") -> Trace:
    return Trace(kind, side=side)


@contextlib.contextmanager
def maybe_trace(trace: Optional[Trace], kind: str, side: str = "local") -> Iterator[Trace]:
    """Join the caller's trace, or own a fresh one: when `trace` is None a
    new trace is created and FINISHED on exit (outcome from the exception
    state); a passed-in trace is yielded untouched — its creator finishes
    it. This is how every solve layer accepts an optional trace without
    double-counting completions."""
    if trace is not None:
        yield trace
        return
    t = new_trace(kind, side=side)
    try:
        yield t
    except BaseException:
        t.finish("error")
        raise
    else:
        t.finish("ok")


def span_of(trace: Optional[Trace], name: str, detail: bool = False, **attrs: Any):
    """trace.span(...) or a no-op context when no trace rides the call
    (the no-op still yields a throwaway dict so `as attrs` writes work)."""
    if trace is None:
        return contextlib.nullcontext({})
    return trace.span(name, detail=detail, **attrs)


def record_fallback(trace: Optional[Trace], reason: str, detail: str = "") -> None:
    """An oracle-degrade decision: a labeled counter bump plus a marker
    span on the trace (the fallback reason recorded as a span and a
    labeled counter). `reason` is a low-cardinality class (unsupported /
    small_batch / forced / tpu_error / partition_continuation /
    prewarm_degraded); the free-text detail stays on the trace only."""
    SOLVE_FALLBACKS.inc({"reason": reason})
    if trace is not None:
        trace.event("oracle_fallback", reason=reason, detail=detail)
