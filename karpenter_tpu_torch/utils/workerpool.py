"""Bounded worker pool: the reconciler-concurrency analog.

The reference scales controller reconcilers with controller-runtime worker
pools (node/termination 100->5000 workers, termination/controller.go:58-60;
disruption queue 100, queue.go:66) and fans independent work out with
k8s.io workqueue.ParallelizeUntil (provisioner.go:153 launches,
scheduler.go:748 candidate scans — the latter became the sweep kernels
here). A copy of the JAX package's `utils/workerpool.py`. This module provides the same primitive for the parts of the
control plane that stay host-side: independent per-object reconciles and
cloud-provider calls.

SimKube CRUD is atomic per op (controllers/kube.py takes a lock around
each op including its watch emit), so concurrent reconciles interact
exactly like controllers against a real apiserver: through optimistic
concurrency, surfacing as Conflict and retried on the next tick.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional


def parallelize_until(
    workers: int, n: int, fn: Callable[[int], None]
) -> list[Optional[Exception]]:
    """k8s.io/client-go workqueue.ParallelizeUntil: run fn(0..n-1) on at
    most `workers` threads, draining every index through ordinary
    failures. Returns the per-index Exception (or None) so the caller
    decides requeue semantics — reconcile errors must not abort sibling
    reconciles. Interrupts (KeyboardInterrupt/SystemExit) DO propagate:
    in the serial path they abort the drain immediately; in the threaded
    path already-submitted indices finish before the interrupt re-raises
    at result consumption."""
    errs: list[Optional[Exception]] = [None] * n
    if n == 0:
        return errs
    if workers <= 1:
        for i in range(n):
            try:
                fn(i)
            # Exception only: KeyboardInterrupt/SystemExit must keep
            # propagating or the control loop becomes un-interruptible
            except Exception as e:
                errs[i] = e
        return errs

    def run(i: int) -> None:
        try:
            fn(i)
        except Exception as e:
            errs[i] = e

    with ThreadPoolExecutor(max_workers=min(workers, n)) as pool:
        list(pool.map(run, range(n)))
    return errs
