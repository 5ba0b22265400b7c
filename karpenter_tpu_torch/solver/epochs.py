"""Epoch-based incremental cluster state for the solver service boundary,
the device-resident table cache and the admission gate.

A copy of the reference's `solver/epochs.py`:

- **Sections** (`sections_from_request` / `materialize_request`): the
  non-pending-pod part of a problem request — node pools, instance
  types, StateNodeViews, daemonsets, and the ClusterSource slice — in an
  indexable form both sides of the wire share. The server materializes a
  full request dict back from them, so a delta-materialized solve decodes
  through the SAME `wire._decode_problem_dict` path a snapshot does:
  decision identity with full resync is by construction.
- **Deltas** (`diff_sections` / `apply_delta`): per-entry upsert/remove
  against a server-held base epoch. Keyed sections diff by natural key
  (views by node name, bound cluster pods by uid, node labels by node
  name, instance types per pool); rare wholesale sections (node pools,
  daemonsets, namespace labels) replace-or-omit. An unchanged section
  costs zero wire bytes.
- **EpochStore**: the bounded per-client epoch store (LRU on both the
  client and epoch axes). Any lookup miss is answered with a retriable
  EPOCH_RESYNC frame and the client falls back to the full-snapshot
  request, so every failure mode (eviction, server restart, mid-delta
  kill, malformed delta) degrades to the decision-identical full-resync
  path instead of corrupting state.
- **Fingerprints** (`problem_fingerprint`, `table_fingerprint`): content
  hashes of every encoded input the device tables derive from. The port's
  `EncodedProblem` has the reference's fields, so the digests equal the
  reference's on the same problem.
- **DeviceTableCache**: content-addressed LRU of table sets uploaded to
  the card (torch tensors on the device), keyed by `problem_fingerprint`.
  Anything the table encoding depends on changes the key, so a stale
  entry is never hit; eviction bounds the device memory dead entries can
  pin. A repeat same-epoch solve hits the cache: it uploads no table
  bytes and launches no type screen (K1).
- **AdmissionGate**: queue-depth + estimated-solve-cost admission in
  front of `SolverServer`'s solve path. When the solve budget is
  oversubscribed the server answers a RETRY frame with a backoff hint
  instead of queueing.

Concurrency contract: every lock in this module is a leaf — nothing
blocking, no device syncs, and no other module lock is taken while one
is held (metric gauge sets acquire the gauge's own inner lock).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.solver import buckets

# -- epoch/admission metrics ----------

EPOCH_SOLVES = metrics.REGISTRY.counter(
    "karpenter_solver_epoch_solves_total",
    "Sidecar solves by request mode: snapshot (epoch-less client), "
    "full_resync (epoch-establishing snapshot), delta.",
    ("mode",),
)
EPOCH_RESYNCS = metrics.REGISTRY.counter(
    "karpenter_solver_epoch_resyncs_total",
    "EPOCH_RESYNC answers by reason (unknown_epoch/apply_error/"
    "decode_error/materialize_error) — each one sends the client down "
    "the full-snapshot path.",
    ("reason",),
)
EPOCHS_RESIDENT = metrics.REGISTRY.gauge(
    "karpenter_solver_epochs_resident",
    "Materialized cluster epochs currently held by the epoch store.",
)
ADMISSION_REJECTED = metrics.REGISTRY.counter(
    "karpenter_solver_admission_rejected_total",
    "Solve requests refused by the admission gate (answered RETRY with "
    "a backoff hint).",
)
ADMISSION_QUEUE_DEPTH = metrics.REGISTRY.gauge(
    "karpenter_solver_admission_queue_depth",
    "Solve requests currently admitted and in flight behind the "
    "admission gate.",
)
TABLE_CACHE = metrics.REGISTRY.counter(
    "karpenter_solver_table_cache_total",
    "Device-table cache lookups on the solve upload path, by outcome "
    "(hit skips the per-class table upload entirely).",
    ("outcome",),
)
ADMISSION_EWMA = metrics.REGISTRY.gauge(
    "karpenter_admission_ewma_solve_seconds",
    "AdmissionGate's EWMA of observed solve wall-clock — the per-request "
    "cost floor the byte estimator is maxed against (0 until the first "
    "completed solve feeds observe()).",
)
TABLE_CACHE_WAIT = metrics.REGISTRY.histogram(
    "karpenter_table_cache_wait_seconds",
    "Seconds a solve spent blocked on another lane's single-flight "
    "device-table build (DeviceTableCache.begin_tables waiters only; "
    "builders and resident hits never wait).",
)


class DeltaError(ValueError):
    """A delta frame that cannot be applied (malformed structure, missing
    keys). Retriable: the server answers EPOCH_RESYNC and the client's
    full-snapshot fallback re-establishes ground truth."""


class SolverOverloaded(RuntimeError):
    """The sidecar refused admission (RETRY frame): the solve budget is
    oversubscribed. Transport is healthy and the problem is fine — the
    caller should solve in-process NOW and honor `backoff_hint_seconds`
    before dialing the sidecar again (ResilientSolver does both, and
    deliberately does NOT count this as a breaker failure). Defined here
    rather than in service.py so hybrid.py can catch it without a
    circular import (service imports hybrid); service re-exports it."""

    def __init__(
        self, msg: str, backoff_hint_seconds: float = 0.0, queue_depth: int = 0
    ):
        super().__init__(msg)
        self.backoff_hint_seconds = float(backoff_hint_seconds)
        self.queue_depth = int(queue_depth)


# ---------------------------------------------------------------------------
# sections: the epoch-resident slice of a problem request


def _pod_uid(d: dict) -> str:
    try:
        return str(d["metadata"]["uid"])
    except (TypeError, KeyError) as e:
        raise DeltaError(f"pod payload without metadata.uid: {e}") from e


def sections_from_request(req: dict) -> dict:
    """Decompose a full-snapshot request dict (wire.encode_problem_dict
    schema) into the indexable epoch sections. Values are shared by
    reference with `req` — sections are immutable once stored; apply_delta
    copies-on-write."""
    cl = req.get("cluster")
    views = req.get("state_node_views")
    cluster_pods: dict[str, list] = {}
    for ns, pods in ((cl or {}).get("pods_by_namespace") or {}).items():
        for p in pods:
            cluster_pods[_pod_uid(p)] = [ns, p]
    return {
        "node_pools": req.get("node_pools") or [],
        "instance_types_by_pool": dict(req.get("instance_types_by_pool") or {}),
        "views": None if views is None else {v["name"]: v for v in views},
        "daemonset_pods": req.get("daemonset_pods") or [],
        "namespace_labels": req.get("namespace_labels") or {},
        "has_cluster": cl is not None,
        "cluster_ns_labels": (cl or {}).get("namespace_labels") or {},
        "cluster_pods": cluster_pods,
        "node_labels": dict((cl or {}).get("node_labels_by_name") or {}),
    }


def materialize_request(
    sections: dict, pods_flat: dict, options: Optional[dict], force_oracle: bool
) -> dict:
    """Reassemble a full request dict from epoch sections + the per-solve
    payload (pending pods, options). The output feeds the SAME
    wire._decode_problem_dict a wire snapshot does. Bound-pod lists
    regroup per namespace in store order — order-insensitive downstream:
    topology counts are sums and the oracle sorts existing nodes itself
    (oracle.py Scheduler.__init__ sorts state views by (initialized,
    name)); the service parity suites pin decision identity."""
    cluster = None
    if sections.get("has_cluster"):
        pods_by_ns: dict[str, list] = {}
        for ns, pod in sections["cluster_pods"].values():
            pods_by_ns.setdefault(ns, []).append(pod)
        cluster = {
            "namespace_labels": sections["cluster_ns_labels"],
            "pods_by_namespace": pods_by_ns,
            "node_labels_by_name": sections["node_labels"],
        }
    views = sections["views"]
    return {
        "namespace_labels": sections["namespace_labels"],
        "cluster": cluster,
        "node_pools": sections["node_pools"],
        "instance_types_by_pool": sections["instance_types_by_pool"],
        "pods_flat": pods_flat,
        "state_node_views": None if views is None else list(views.values()),
        "daemonset_pods": sections["daemonset_pods"],
        "options": options or {},
        "force_oracle": bool(force_oracle),
    }


# wholesale sections: rare churn, replaced in full when they change at all
_FULL_SECTIONS = (
    "node_pools",
    "daemonset_pods",
    "namespace_labels",
    "has_cluster",
    "cluster_ns_labels",
)
# keyed sections: diffed per entry by natural key
_KEYED_SECTIONS = (
    "instance_types_by_pool",  # pool name -> jsonable type list
    "views",  # node name -> view dict (None = no views at all)
    "cluster_pods",  # pod uid -> [namespace, jsonable pod]
    "node_labels",  # node name -> labels
)


def diff_sections(old: dict, new: dict) -> dict:
    """Per-section delta from `old` to `new`. Unchanged sections are
    omitted entirely (zero wire bytes). Keyed sections carry
    {"set": {key: value}, "del": [keys]}; wholesale sections and
    None-transitions carry {"full": value}."""
    delta: dict[str, Any] = {}
    for name in _FULL_SECTIONS:
        if old.get(name) != new.get(name):
            delta[name] = {"full": new.get(name)}
    for name in _KEYED_SECTIONS:
        o, n = old.get(name), new.get(name)
        if o == n:
            continue
        if o is None or n is None:
            delta[name] = {"full": n}
            continue
        upsert = {k: v for k, v in n.items() if k not in o or o[k] != v}
        gone = [k for k in o if k not in n]
        delta[name] = {"set": upsert, "del": gone}
    return delta


def apply_delta(base: dict, delta: dict) -> dict:
    """Copy-on-write application: the returned sections share untouched
    section objects with `base` (epochs are immutable once stored — a
    later resync to the base epoch must see it unmutated); touched keyed
    sections get a fresh outer mapping. Raises DeltaError on anything
    malformed — the caller answers EPOCH_RESYNC, never a corrupted
    epoch."""
    if not isinstance(delta, dict):
        raise DeltaError(f"delta must be an object, got {type(delta).__name__}")
    out = dict(base)
    for name, change in delta.items():
        if name not in _FULL_SECTIONS and name not in _KEYED_SECTIONS:
            raise DeltaError(f"unknown delta section {name!r}")
        if not isinstance(change, dict):
            raise DeltaError(f"section {name!r}: change must be an object")
        if "full" in change:
            out[name] = change["full"]
            continue
        if name in _FULL_SECTIONS:
            raise DeltaError(f"section {name!r} only supports full replacement")
        current = out.get(name)
        if current is None:
            raise DeltaError(f"section {name!r}: keyed delta against None base")
        updated = dict(current)
        for k in change.get("del") or []:
            updated.pop(k, None)
        upserts = change.get("set") or {}
        if not isinstance(upserts, dict):
            raise DeltaError(f"section {name!r}: 'set' must be an object")
        if name == "cluster_pods":
            for uid, entry in upserts.items():
                if not (isinstance(entry, list) and len(entry) == 2):
                    raise DeltaError(
                        "cluster_pods entries must be [namespace, pod]"
                    )
        updated.update(upserts)
        out[name] = updated
    return out


# ---------------------------------------------------------------------------
# the bounded per-client epoch store


class EpochStore:
    """Server-held materialized cluster sections keyed by
    (client id, epoch id), bounded LRU on both axes. Misses are the
    RESYNC path — eviction is always safe because the client's
    full-snapshot fallback re-establishes ground truth (service.py wire
    contract).

    Thread safety: handler threads get/put concurrently; one leaf lock
    guards the maps (the resident-count gauge is set under it — the same
    outer->inner ordering metrics.Store documents, and never inverted)."""

    def __init__(self, max_clients: int = 8, max_epochs: int = 4):
        self.max_clients = max_clients
        self.max_epochs = max_epochs
        self._lock = threading.Lock()
        self._clients: "OrderedDict[str, OrderedDict[int, dict]]" = OrderedDict()

    def get(self, client: Optional[str], epoch: Any) -> Optional[dict]:
        if client is None:
            return None
        with self._lock:
            epochs = self._clients.get(client)
            if epochs is None:
                return None
            sections = epochs.get(epoch)
            if sections is None:
                return None
            epochs.move_to_end(epoch)
            self._clients.move_to_end(client)
            return sections

    def put(self, client: str, epoch: Any, sections: dict) -> None:
        with self._lock:
            epochs = self._clients.setdefault(client, OrderedDict())
            epochs[epoch] = sections
            epochs.move_to_end(epoch)
            self._clients.move_to_end(client)
            while len(epochs) > self.max_epochs:
                epochs.popitem(last=False)
            while len(self._clients) > self.max_clients:
                self._clients.popitem(last=False)
            self._publish_locked()

    def stats(self) -> tuple[int, int]:
        """(clients, total resident epochs) — the PONG payload fields."""
        with self._lock:
            return len(self._clients), sum(
                len(e) for e in self._clients.values()
            )

    def clear(self) -> None:
        with self._lock:
            self._clients.clear()
            self._publish_locked()

    def _publish_locked(self) -> None:
        EPOCHS_RESIDENT.set(
            float(sum(len(e) for e in self._clients.values()))
        )


# ---------------------------------------------------------------------------
# fingerprints


def _feed(h, x: Any) -> None:
    if x is None:
        h.update(b"\x00N")
    elif isinstance(x, np.ndarray):
        h.update(repr((x.dtype.str, x.shape)).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (bool, int, float, str, bytes, np.integer, np.floating)):
        h.update(repr(x).encode())
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif isinstance(x, dict):
        h.update(b"{")
        for k in sorted(x):
            _feed(h, k)
            _feed(h, x[k])
        h.update(b"}")
    else:
        # silent skips would let two different problems share a key;
        # fail loudly so a new EncodedProblem field gets a hashing rule
        raise TypeError(f"unhashable fingerprint component {type(x).__name__}")


# EncodedProblem fields that are host objects, not table inputs: the
# scheduler/pods feed only the decode side, and the group/requirement
# OBJECTS are fully represented by the encoded arrays plus the attrs fed
# explicitly below (v_anti from group.type, h_inverse from .inverse)
_FP_SKIP = frozenset(
    {"scheduler", "pods", "vocab", "table", "vgroups", "hgroups", "rt_tier_reqs"}
)

# Additional skips for the TABLE-level fingerprint (fleet lane grouping,
# solver/fleet.py): the per-pod identity columns and per-encode-class
# tables listed here ride the per-LANE State/PodX side of a fleet
# dispatch — they are gathered into each lane's own PodX from each
# lane's own _dev_tables — so two requests that differ only in them can
# still share ONE Tables set on the device. Everything a shared
# tb (tpu.py _tables) or the lane State SHAPES derive from stays hashed:
# templates/types/offerings, topology group tables, the relax-tier
# tables (PodX.rrow indexes the SHARED tb.rt_* rows, so those arrays
# must be byte-equal across lanes), vocab/resource layouts, and every
# scalar dim.
_TABLE_FP_SKIP = _FP_SKIP | frozenset(
    {
        "pod_class",
        "srow",
        "class_reps",
        "rcls_of",
        "rclass_creps",
        "preq_c",
        "prequests_c",
        "ptol_t_c",
        "ptol_e_c",
        "ptopo_kind_c",
        "ptopo_gid_c",
        "ptopo_sel_c",
        "pinv_h_c",
        "pown_h_c",
        "sel_rows_v",
        "sel_rows_h",
        "php_own_c",
        "php_conf_c",
    }
)


def _field_digest(problem, name: str, cache: dict) -> bytes:
    got = cache.get(name)
    if got is None:
        h = hashlib.blake2b(digest_size=16)
        _feed(h, getattr(problem, name))
        got = h.digest()
        cache[name] = got
    return got


def _fingerprint(problem, skip: frozenset) -> str:
    """Hash-of-field-hashes with a per-problem-instance digest memo: a
    caller that takes both fingerprints of one problem pays the expensive
    part (a blake2b pass over each MB-scale array) once per FIELD, and
    the second fingerprint only combines ~a hundred cached 16-byte
    digests. Safe because an EncodedProblem is built fresh per solve and
    not mutated between the two calls."""
    cache = getattr(problem, "_ktpu_fp_cache", None)
    if cache is None:
        cache = {}
        problem._ktpu_fp_cache = cache
    h = hashlib.blake2b(digest_size=16)
    _feed(h, bool(buckets.enabled()))
    for f in dataclasses.fields(problem):
        if f.name in skip:
            continue
        h.update(f.name.encode())
        h.update(_field_digest(problem, f.name, cache))
    meta = cache.get("__meta__")
    if meta is None:
        mh = hashlib.blake2b(digest_size=16)
        vocab = problem.vocab
        _feed(mh, (vocab.keys, vocab.values, vocab.words_per_key))
        table = problem.table
        _feed(mh, (table.names, table.scale))
        for g in problem.vgroups:
            _feed(
                mh,
                (g.kid, g.skew, g.min_domains, tuple(g.filt), g.group.type.value),
            )
        for g in problem.hgroups:
            _feed(mh, (g.skew, bool(g.inverse), tuple(g.filt)))
        meta = mh.digest()
        cache["__meta__"] = meta
    h.update(meta)
    return h.hexdigest()


def problem_fingerprint(problem) -> str:
    """Content hash of every encoded input the device tables derive from
    (tpu.py _tables + _upload_pod_tables + the vocab/resource layouts
    behind them). Two problems with equal fingerprints upload identical
    tables, so a cache hit is exact by construction; anything the table
    encoding depends on — a relax-rung mutation, a drifted label value,
    an instance-type change — perturbs some encoded array and misses.
    Hash cost is host memory bandwidth over a few MB of tables."""
    return _fingerprint(problem, _FP_SKIP)


def table_fingerprint(problem) -> str:
    """The fleet-lane grouping key (solver/fleet.py): like
    problem_fingerprint but EXCLUDING the per-pod / per-encode-class
    columns that ride each lane's own PodX. Two problems with equal
    table fingerprints share one `Tables` set (read by every lane of a
    fleet dispatch) and produce shape-compatible States, so their solves
    can stack on a fleet axis; distinct pending-pod batches — different
    requests, names, counts within a pow-2 rung — still coalesce.
    Skipping MORE than tb
    reads would be unsound (lanes could share a wrong tb); skipping
    LESS only narrows coalescing, so the skip list is the conservative
    per-pod set."""
    return _fingerprint(problem, _TABLE_FP_SKIP)


class DeviceTableCache:
    """Content-addressed LRU of table sets on the card
    (fingerprint -> (tb, typeok, dev_tables, aff_c)): `K.Tables`, the pod
    x type screen and the per-class pod tables as torch tensors on the
    device, and the host affinity flags. Entries are shared by concurrent
    solves on several host threads, so nothing writes them in place after
    the put: the solve driver only reads tables (its kernels write the
    State and their outputs) and every handler thread launches on its own
    current stream, the device's default one, so a tensor published by
    one thread is complete before another thread's launch reads it.
    Capacity bounds the device memory resident entries can pin.
    Invalidation is structural: a changed encoding changes the
    fingerprint, so stale entries are unreachable and age out.

    Two levels:

    - the FULL entry, keyed by `problem_fingerprint` — a hit skips every
      upload and the type screen;
    - the SHARED-TABLES entry (`get_tables`/`put_tables`), keyed by
      `table_fingerprint` — `K.Tables` is a function of the table-hashed
      fields alone (solver/fleet.py's stacking precondition), so
      coalesced same-epoch solves whose PENDING-POD batches differ still
      share ONE tables build and rebuild only their per-lane pod tables.

    Builds are SINGLE-FLIGHT per table fingerprint (`begin_tables` /
    `end_tables`): concurrent misses — a fleet window's lanes all
    encoding before any put lands — elect one builder, the rest wait on
    its per-key event and take the resident tables. The wait is bounded
    and failure-safe: a builder that dies publishes None and the waiter
    builds its own copy (degraded, never wrong or stuck)."""

    # a waiting lane outlasting this means the builder thread died
    # un-Pythonically mid-upload; waiters then build their own copy
    BUILD_WAIT_SECONDS = 600.0

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._items: "OrderedDict[str, tuple]" = OrderedDict()
        self._tables: "OrderedDict[str, Any]" = OrderedDict()
        self._building: dict[str, threading.Event] = {}

    def get(self, key: str):
        with self._lock:
            got = self._items.get(key)
            if got is not None:
                self._items.move_to_end(key)
        TABLE_CACHE.inc({"outcome": "hit" if got is not None else "miss"})
        return got

    def put(self, key: str, value: tuple) -> None:
        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)

    def get_tables(self, table_key: str):
        """The resident shared `K.Tables` for a table fingerprint,
        or None. Counted as its own outcome so the serving telemetry can
        tell a tb-share (per-lane pod tables still upload) from a full
        hit."""
        with self._lock:
            tb = self._tables.get(table_key)
            if tb is not None:
                self._tables.move_to_end(table_key)
        if tb is not None:
            TABLE_CACHE.inc({"outcome": "tables_hit"})
        return tb

    def put_tables(self, table_key: str, tb) -> None:
        with self._lock:
            self._tables[table_key] = tb
            self._tables.move_to_end(table_key)
            while len(self._tables) > self.capacity:
                self._tables.popitem(last=False)

    def begin_tables(self, table_key: str):
        """Single-flight election for one tb materialization. Returns
        (tb, None) when the tables are already resident, else
        (None, token): a truthy token means THIS caller builds (and must
        end_tables in a finally); None means a sibling built while we
        waited — re-check get_tables, and on a publish failure build
        anyway. The event wait happens OUTSIDE the lock (leaf-lock
        contract)."""
        waited_since = None
        while True:
            with self._lock:
                tb = self._tables.get(table_key)
                if tb is not None:
                    self._tables.move_to_end(table_key)
                else:
                    ev = self._building.get(table_key)
                    if ev is None:
                        self._building[table_key] = threading.Event()
                        elected = True
                    else:
                        elected = False
            if tb is None and elected:
                # waited on a build that failed to publish, then won the
                # re-election: the wait still happened — record it
                if waited_since is not None:
                    TABLE_CACHE_WAIT.observe(time.monotonic() - waited_since)
                return None, table_key
            if tb is not None:
                TABLE_CACHE.inc({"outcome": "tables_hit"})
                if waited_since is not None:
                    TABLE_CACHE_WAIT.observe(time.monotonic() - waited_since)
                return tb, None
            if waited_since is None:
                waited_since = time.monotonic()
            if not ev.wait(self.BUILD_WAIT_SECONDS):
                # builder thread destroyed mid-upload: evict the stale
                # election (if it is still ours) so the KEY recovers —
                # later solves elect a fresh builder instead of each
                # stalling the full wait — wake fellow waiters, and
                # build our own copy
                with self._lock:
                    if self._building.get(table_key) is ev:
                        del self._building[table_key]
                ev.set()
                TABLE_CACHE_WAIT.observe(time.monotonic() - waited_since)
                return None, None

    def end_tables(self, token, tb) -> None:
        """Publish a single-flight build (tb=None on failure: waiters are
        woken and fall back to building their own copies)."""
        if token is None:
            return
        with self._lock:
            if tb is not None:
                self._tables[token] = tb
                self._tables.move_to_end(token)
                while len(self._tables) > self.capacity:
                    self._tables.popitem(last=False)
            ev = self._building.pop(token, None)
        if ev is not None:
            ev.set()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._tables.clear()


# ---------------------------------------------------------------------------
# admission control


class AdmissionGate:
    """Queue-depth + estimated-cost admission in front of the server's
    solve path. The gate never queues: an oversubscribed request is
    answered immediately with a RETRY frame carrying a backoff hint, so
    the caller's deadline budget degrades it to the in-process ladder
    instead of cascading (ResilientSolver honors the hint before
    re-dialing).

    Cost model: the byte estimator charges wire bytes at a conservative
    decode rate, but wire bytes UNDER-state delta solves (a delta frame
    is O(churn) while its solve is O(cluster + pods)), so the gate also
    keeps an EWMA of *observed* solve wall-clock (`observe`, fed by the
    server after each completed solve) and charges every request at
    least that much — the budget protection tracks what solves actually
    cost on this box, independent of which wire form carried them."""

    def __init__(
        self,
        max_inflight: int = 4,
        max_cost_seconds: float = 120.0,
        estimator: Optional[Callable[[int], float]] = None,
    ):
        self.max_inflight = max_inflight
        self.max_cost_seconds = max_cost_seconds
        self._estimate = estimator or self._default_estimate
        self._lock = threading.Lock()
        self._inflight: dict[int, float] = {}
        self._cost = 0.0
        self._next_token = 0
        self._ewma_seconds = 0.0

    @staticmethod
    def _default_estimate(payload_len: int) -> float:
        # ~32 MB/s of payload decode + solve work, 50 ms floor: measured
        # order-of-magnitude on the tier-1 container; deliberately
        # conservative (over-admitting is what the gate exists to stop)
        return 0.05 + payload_len / (32 * 1024 * 1024)

    def observe(self, solve_seconds: float) -> None:
        """Feed a completed solve's wall-clock into the cost EWMA."""
        s = max(0.0, float(solve_seconds))
        with self._lock:
            if self._ewma_seconds == 0.0:
                self._ewma_seconds = s
            else:
                self._ewma_seconds = 0.8 * self._ewma_seconds + 0.2 * s
            ewma = self._ewma_seconds
        # export outside the lock (leaf-lock discipline): the EWMA used
        # to be invisible — an operator could not tell WHY the gate
        # started rejecting after one slow solve
        ADMISSION_EWMA.set(ewma)

    def try_admit(self, payload_len: int):
        """(token, hint_seconds, depth): token is None on rejection, with
        `hint_seconds` the estimated wait for capacity to free up."""
        with self._lock:
            floor = self._ewma_seconds
        est = max(float(self._estimate(payload_len)), floor)
        with self._lock:
            depth = len(self._inflight)
            # an IDLE gate always admits: one in-flight solve can never
            # oversubscribe worse than serial execution, and without this
            # escape a single pathological observation (one solve slower
            # than max_cost_seconds) would push the EWMA above the budget
            # and reject everything forever — observe() only updates on
            # completed solves, so rejection would be permanent
            if depth >= self.max_inflight or (
                depth > 0 and self._cost + est > self.max_cost_seconds
            ):
                hint = max(0.05, self._cost / max(1, self.max_inflight))
                rejected = True
                token = None
            else:
                rejected = False
                self._next_token += 1
                token = self._next_token
                self._inflight[token] = est
                self._cost += est
                depth += 1
                hint = 0.0
            ADMISSION_QUEUE_DEPTH.set(float(len(self._inflight)))
        if rejected:
            ADMISSION_REJECTED.inc()
        return token, round(hint, 3), depth

    def release(self, token: Optional[int]) -> None:
        if token is None:
            return
        with self._lock:
            self._cost -= self._inflight.pop(token, 0.0)
            if not self._inflight:
                self._cost = 0.0  # clamp float drift at idle
            ADMISSION_QUEUE_DEPTH.set(float(len(self._inflight)))

    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)
