"""SimKube: the in-memory API store standing in for the kube-apiserver.

Semantics mirrored from Kubernetes because the reference's correctness
leans on them (reference pkg/operator/operator.go, controller-runtime):
- optimistic concurrency: update() rejects stale resource_version (the
  conflict-requeue pattern in disruption/controller.go:146)
- finalizers: delete() only marks deletion_timestamp while finalizers
  remain; objects vanish when the last finalizer is removed
- watch: subscribers get (event_type, kind, obj) in commit order, on the
  committing thread but AFTER the store lock is released (the _pump event
  queue) — the informer layer (controllers/state.py wire_informers) builds
  the cluster cache from these, exactly like the reference's informer
  controllers (pkg/controllers/state/informer/)

Stored kinds are the framework's dataclasses (karpenter_tpu_torch.api.objects):
Pod, Node, NodeClaim, NodePool, DaemonSet.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time as time_mod
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.api.objects import Node, Pod

ADDED = "added"
UPDATED = "updated"
DELETED = "deleted"


class Conflict(Exception):
    """Optimistic-concurrency failure (HTTP 409 equivalent)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


class RealClock:
    def now(self) -> float:
        return time_mod.monotonic()


class FakeClock:
    """Manually advanced clock for deterministic controller tests (the
    reference uses k8s.io/utils/clock/testing the same way)."""

    def __init__(self, start: float = 1000.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds


@dataclass
class Namespace:
    """Minimal Namespace: name + labels, for affinity namespaceSelector
    resolution (reference topology.go:503 lists Namespace objects)."""

    name: str
    labels: dict = field(default_factory=dict)


@dataclass
class DaemonSet:
    """Minimal DaemonSet: the provisioner only needs the pod template for
    daemon overhead computation (reference provisioner.go:477)."""

    name: str
    pod_template: Pod = field(default_factory=Pod)


Subscriber = Callable[[str, str, object], None]


class SimKube:
    def __init__(self, clock=None) -> None:
        self._stores: dict[str, dict[str, object]] = {}
        self._version = itertools.count(1)
        self._subscribers: list[Subscriber] = []
        self.clock = clock if clock is not None else RealClock()
        # Each CRUD op (including its synchronous watch emit) is atomic
        # under this lock, so controller reconciles may run on a worker
        # pool (utils/workerpool.py) the way the reference scales its
        # reconcilers (termination/controller.go:58-60). Cross-op races
        # surface as Conflict — the same optimistic-concurrency contract
        # the real apiserver gives controller-runtime.
        self._lock = threading.RLock()
        self._events: list[tuple[str, str, object]] = []
        self._emitting = False  # guarded by self._lock

    # -- watch ------------------------------------------------------------

    def subscribe(self, fn: Subscriber) -> None:
        self._subscribers.append(fn)

    def _emit(self, event: str, kind: str, obj) -> None:
        """Queue a watch event. Called under self._lock; delivery happens
        in _pump AFTER the lock is released — a subscriber that blocks or
        takes another lock must not deadlock against worker-pool
        reconciles doing store CRUD, and subscriber work must not
        serialize the store. The queue-then-drain shape keeps the store
        lock a leaf in the program's acquisition graph: graftlint's
        race-blocking-hold flags blocking calls SimKube itself makes
        under the lock, but a subscriber's own locks live in other
        classes the static graph does not follow — keeping delivery
        outside the lock is what makes that blind spot moot."""
        self._events.append((event, kind, obj))

    def _pump(self) -> None:
        """Deliver queued events in commit order outside the lock. One
        thread drains at a time (the _emitting flag), so global ordering
        is preserved even when several workers mutate concurrently; a
        subscriber that mutates the store re-queues and the draining
        thread picks the new events up on the next loop."""
        while True:
            with self._lock:
                if self._emitting or not self._events:
                    return
                self._emitting = True
                batch = list(self._events)
                self._events.clear()
            try:
                for event, kind, obj in batch:
                    for fn in self._subscribers:
                        try:
                            fn(event, kind, obj)
                        except Exception as e:  # noqa: BLE001
                            # a broken subscriber must not swallow the rest
                            # of the batch (other commits' events) nor mask
                            # the committing caller's CRUD exception — the
                            # same contract informers get from a real
                            # apiserver watch (log and keep streaming)
                            # (the port has no structured logger yet; the
                            # standard library's takes its place)
                            import logging

                            logging.getLogger("karpenter_tpu_torch.kube.watch").error(
                                "watch subscriber failed: event=%s kind=%s error=%s: %s",
                                event, kind, type(e).__name__, e,
                            )
            finally:
                with self._lock:
                    self._emitting = False

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _name(obj) -> str:
        meta = getattr(obj, "metadata", None)
        return meta.name if meta is not None else obj.name

    def _store(self, kind: str) -> dict[str, object]:
        return self._stores.setdefault(kind, {})

    # -- CRUD -------------------------------------------------------------

    def create(self, kind: str, obj):
        try:
            with self._lock:
                store = self._store(kind)
                name = self._name(obj)
                if name in store:
                    raise AlreadyExists(f"{kind}/{name}")
                obj = copy.deepcopy(obj)
                if getattr(obj, "metadata", None) is not None:
                    obj.metadata.resource_version = next(self._version)
                    # the apiserver stamps creationTimestamp at admission;
                    # age-based controllers (expiration, lifetime cost)
                    # depend on it. A 0.0 timestamp is treated as UNSET
                    # (the dataclass default) — a test modeling an old
                    # object must backdate with any positive epoch.
                    if not obj.metadata.creation_timestamp:
                        obj.metadata.creation_timestamp = self.clock.now()
                store[name] = obj
                self._emit(ADDED, kind, copy.deepcopy(obj))
                return copy.deepcopy(obj)
        finally:
            self._pump()

    def get(self, kind: str, name: str):
        with self._lock:
            obj = self._store(kind).get(name)
            if obj is None:
                raise NotFound(f"{kind}/{name}")
            return copy.deepcopy(obj)

    def try_get(self, kind: str, name: str):
        with self._lock:
            obj = self._store(kind).get(name)
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, kind: str, filter: Optional[Callable[[object], bool]] = None):
        with self._lock:
            # the filter reads the stored objects (it must not mutate
            # them), so only the objects it keeps are copied
            objs = self._store(kind).values()
            return [copy.deepcopy(o) for o in objs if filter is None or filter(o)]

    def update(self, kind: str, obj):
        """Optimistic-concurrency update; finalizer-clearing completes a
        pending delete."""
        try:
            with self._lock:
                store = self._store(kind)
                name = self._name(obj)
                current = store.get(name)
                if current is None:
                    raise NotFound(f"{kind}/{name}")
                if obj.metadata.resource_version != current.metadata.resource_version:
                    raise Conflict(
                        f"{kind}/{name}: version {obj.metadata.resource_version} != "
                        f"{current.metadata.resource_version}"
                    )
                obj = copy.deepcopy(obj)
                obj.metadata.resource_version = next(self._version)
                if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                    del store[name]
                    self._emit(DELETED, kind, copy.deepcopy(obj))
                    return None
                store[name] = obj
                self._emit(UPDATED, kind, copy.deepcopy(obj))
                return copy.deepcopy(obj)
        finally:
            self._pump()

    def delete(self, kind: str, name: str, now: Optional[float] = None):
        try:
            with self._lock:
                store = self._store(kind)
                current = store.get(name)
                if current is None:
                    raise NotFound(f"{kind}/{name}")
                if current.metadata.finalizers:
                    if current.metadata.deletion_timestamp is None:
                        current.metadata.deletion_timestamp = (
                            self.clock.now() if now is None else now
                        )
                        current.metadata.resource_version = next(self._version)
                        self._emit(UPDATED, kind, copy.deepcopy(current))
                    return None
                del store[name]
                self._emit(DELETED, kind, copy.deepcopy(current))
                return None
        finally:
            self._pump()

    # -- typed conveniences ----------------------------------------------

    def bind(self, pod_name: str, node_name: str) -> None:
        """The kube-scheduler binding equivalent."""
        try:
            with self._lock:
                pod = self._store("Pod").get(pod_name)
                if pod is None:
                    raise NotFound(f"Pod/{pod_name}")
                pod.node_name = node_name
                pod.metadata.resource_version = next(self._version)
                self._emit(UPDATED, "Pod", copy.deepcopy(pod))
        finally:
            self._pump()

    def pending_pods(self) -> list[Pod]:
        return self.list(
            "Pod",
            lambda p: not p.node_name
            and p.metadata.deletion_timestamp is None
            and not p.scheduling_gates,
        )

    def ready_nodes(self) -> list[Node]:
        return self.list(
            "Node",
            lambda n: n.ready
            and not n.unschedulable
            and n.metadata.deletion_timestamp is None,
        )
