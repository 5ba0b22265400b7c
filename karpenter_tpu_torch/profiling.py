"""Profiling: the pprof equivalent of the reference operator (a copy of the
JAX package's `profiling.py`, with the device trace on torch's profiler).

Reference pkg/operator/operator.go:183-199 registers Go
pprof handlers (/debug/pprof/profile, /heap, ...) on the metrics port
behind --enable-profiling. This module provides the same capabilities for
the single-process Python operator:

- StackSampler — a sampling CPU profiler over ``sys._current_frames()``
  (all threads, default 100 Hz). Output is collapsed-stack format
  ("frame;frame;frame count" lines), the interchange format flamegraph
  tooling and pprof both ingest; no signals, no tracing overhead when idle.
- heap_snapshot() — tracemalloc top-N allocation sites (pprof /heap
  analog). tracemalloc is started lazily on first use.
- device_trace() — a context manager around ``torch.profiler.profile``
  over the CPU and (where there is a card) CUDA activities: it writes a
  Chrome trace (chrome://tracing, Perfetto) of the enclosed block, with
  each kernel launch and its device time, the accelerator-side analog of
  the benchmark harness's pprof profiles
  (scheduling_benchmark_test.go:114-160).

The HTTP surface (/debug/pprof/profile?seconds=N, /debug/pprof/heap) is
served by controllers/probes.ProbeServer when Options.enable_profiling is
set, mirroring the reference's flag gate.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import Counter
from typing import Iterator, Optional


class StackSampler:
    """Sampling profiler over every live thread's current stack."""

    def __init__(self, hz: float = 100.0):
        self.hz = hz
        self.samples: Counter[str] = Counter()
        self.total = 0

    def _collect_once(self, skip_idents: frozenset[int]) -> None:
        for ident, frame in sys._current_frames().items():
            if ident in skip_idents:
                continue
            parts = []
            f = frame
            depth = 0
            while f is not None and depth < 64:
                code = f.f_code
                parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
                f = f.f_back
                depth += 1
            # root-first, like collapsed-stack consumers expect
            self.samples[";".join(reversed(parts))] += 1
            self.total += 1

    def run(self, seconds: float) -> "StackSampler":
        """Sample for the given duration from the calling thread."""
        skip = frozenset({threading.get_ident()})
        interval = 1.0 / self.hz
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            self._collect_once(skip)
            time.sleep(interval)
        return self

    def render_collapsed(self) -> str:
        """Collapsed-stack lines, most-sampled first."""
        return "\n".join(
            f"{stack} {count}"
            for stack, count in self.samples.most_common()
        )

    def render_top(self, n: int = 30) -> str:
        """pprof 'top'-style table of leaf frames."""
        leaves: Counter[str] = Counter()
        for stack, count in self.samples.items():
            leaves[stack.rsplit(";", 1)[-1]] += count
        total = max(self.total, 1)
        lines = [f"samples: {self.total}  rate: {self.hz:.0f} Hz"]
        for frame, count in leaves.most_common(n):
            lines.append(f"{count:8d} {100.0 * count / total:5.1f}%  {frame}")
        return "\n".join(lines)


def profile_cpu(seconds: float = 1.0, hz: float = 100.0) -> StackSampler:
    """Sample all threads for `seconds`; returns the sampler."""
    return StackSampler(hz=hz).run(seconds)


_tracemalloc_started = False
# ThreadingHTTPServer can run two /debug/pprof/heap requests concurrently;
# the start/snapshot/stop sequence must be atomic or one request can call
# take_snapshot after the other stopped tracing (RuntimeError -> 500)
_tracemalloc_lock = threading.Lock()


def heap_snapshot(top: int = 30, keep_tracing: bool = False) -> str:
    """Top allocation sites by retained bytes (pprof /heap analog).
    tracemalloc starts on the first call — earlier allocations are
    invisible, matching the lazy semantics of enabling a heap profiler on
    a running process. Tracing is stopped again after the snapshot unless
    keep_tracing is set (full tracing costs multi-x allocation overhead,
    too expensive to leave on permanently from one debug request); two
    calls therefore show allocations between them only with
    keep_tracing=True on the first."""
    import tracemalloc

    global _tracemalloc_started
    with _tracemalloc_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            _tracemalloc_started = True
        snap = tracemalloc.take_snapshot()
        # stop tracing we own unless asked to keep it (so a keep_tracing
        # call followed by a plain one turns it back off); tracing started
        # by the application itself is left alone
        if _tracemalloc_started and not keep_tracing:
            tracemalloc.stop()
            _tracemalloc_started = False
    all_stats = snap.statistics("lineno")
    total = sum(s.size for s in all_stats)
    lines = [f"heap: {total} bytes traced (since profiling was enabled)"]
    for s in all_stats[:top]:
        frame = s.traceback[0]
        lines.append(
            f"{s.size:12d} B {s.count:8d} objs  "
            f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno}"
        )
    return "\n".join(lines)


TRACE_NAME = "device_trace.json"


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``<logdir>/device_trace.json`` (the directory is made).
    CUDA activity is recorded when a card is present, CPU activity always;
    yields the profiler, whose ``key_averages()`` the caller may read after
    the block."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


# The per-solve phase breakdown (the Measure defer-timer analog,
# pkg/metrics/constants.go:63) lives in karpenter_tpu_torch.tracing:
# TorchScheduler.last_profile is a tracing.Trace — .phases /
# .top_phases() / .render() give the breakdown the old SolveProfile did,
# plus spans, the /debug/solves ring, and the phase metrics.
