"""Problem fingerprints: the fleet window's key.

A copy of the fingerprint half of the reference's `solver/epochs.py`
(epochs.py:361-507): `problem_fingerprint` hashes every encoded input the
device tables derive from, and `table_fingerprint` the same without the
per-pod and per-encode-class columns that ride each lane's own PodX. Two
problems with equal table fingerprints share one `Tables` set and produce
shape-compatible States, so their solves can stack on a fleet axis
(solver/fleet.py). The port's `EncodedProblem` has the reference's
fields, so the digests equal the reference's on the same problem.

The epoch store, the device table cache and the admission gate of the
reference's module are not here yet: they come with the solver sidecar.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from karpenter_tpu_torch.solver import buckets


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
