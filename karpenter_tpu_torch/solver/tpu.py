"""TorchScheduler: the provisioning solve on torch tensors.

A port of the reference's `solver/tpu.py` `TpuScheduler`: the same
constructor and `solve(pods) -> Results` surface, wrapping the port's copy
of `oracle.Scheduler` the same way. A solve runs

1. host encode (`tpu_problem.encode_problem`),
2. the FFD order (`_order_pods`),
3. table upload with the pod x type screen (`_tables`, `_pod_typeok`
   through the `typeok_screen` kernel, `_upload_pod_tables`), and for a
   problem with preference ladders the tier tables and their type screen
   (`_tier_typeok`, the same kernel),
4. requeue rounds, on one of two paths chosen as the reference chooses:
   - the runs path, whenever a pod class passes the bulk gates
     (`_bulk_gates`, `_bulk_class_flags`): `_pod_xs_with_idx` gathers a
     round's rows, `run_arrays` (kernel K4) derives the run driver arrays
     and `tpu_runs.solve_runs` (kernel K3, `run_step`) walks the round; a
     claim-slot overflow stops the walk on the overflowing pod, the state
     grows from N to 2N slots (`_grow`) and the round goes on from there;
   - the scan path otherwise (or with `debug_force_scan`): `_pod_xs`,
     then `tpu_kernel.solve_scan` (kernel K2, `scan_step`); an overflow
     doubles N and re-solves from scratch. With a `fleet` coalescer the
     scan path first offers itself to a batch window (solver/fleet.py),
     whose lanes share one K7 launch per round,
5. `_decode` back to Results, fetching the live claim rows (deduplicated by
   `dedup_rows`, kernel K5, from `_DEDUP_DECODE_MIN` slots up) and writing
   claims, existing-node usage, pool limits and topology counts onto the
   shared oracle.

Each step is a span of the solve's trace (`solve(pods, trace=None)`; a
standalone solve owns a "tpu_solve" trace, `last_profile`): encode, order,
upload (with the table cache's `hit`/`tables_hit`/`miss` event and the
`upload_bytes` count), the `bucket` event, one `dispatch` span a kernel
launch carrying its odometer block, `regrow`, decode; `last_phases` is this
solve's share of those phases. With a `table_cache` (an
epochs.DeviceTableCache, the sidecar's), a problem-fingerprint hit takes
the tables, the pod x type screen and the pod tables from the card as they
lie (no upload, no K1 launch), and a table-fingerprint hit rebuilds only
the pod tables against the shared K.Tables.

Decisions are bit-identical to the oracle's for supported problems. A
problem with a relaxable requirement class (preferred node or pod
(anti-)affinity, ScheduleAnyway spreads, required node-affinity OR-terms)
runs both kernels with the relax tier loop on (`last_relax`): such a pod
tries its tiers in order inside its own step, as the reference does.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import time as time_mod
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from karpenter_tpu_torch import _build, tracing
from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import NodePool, Operator, Pod
from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
from karpenter_tpu_torch.device import pack, resolve_device, to_tensor
from karpenter_tpu_torch.ops.encode import Reqs, decode_row, empty_reqs
from karpenter_tpu_torch.ops.kernels import VocabArrays, intersects_only
from karpenter_tpu_torch.scheduling import Requirement, Requirements
from karpenter_tpu_torch.solver import buckets
from karpenter_tpu_torch.solver import nodes as nodes_mod
from karpenter_tpu_torch.solver.epochs import problem_fingerprint, table_fingerprint
from karpenter_tpu_torch.solver import tpu_kernel as K
from karpenter_tpu_torch.solver import tpu_runs as KR
from karpenter_tpu_torch.solver.nodes import (
    SchedulingNodeClaim,
    StateNodeView,
    filter_instance_types,
)
from karpenter_tpu_torch.solver.oracle import Results, Scheduler, SchedulerOptions
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu_problem import (
    TOPO_AFFINITY_H,
    TOPO_AFFINITY_V,
    TOPO_ANTI_V,
    TOPO_SPREAD_V,
    EncodedProblem,
    _pow2,
    encode_problem,
)
from karpenter_tpu_torch.utils import resources as res

# launches of the CUDA kernels wrapped in this module
LAUNCHES = {"typeok_screen": 0, "run_arrays": 0, "dedup_rows": 0}


# ---------------------------------------------------------------------------
# K1 typeok_screen
#
# Replaces karpenter_tpu/solver/tpu.py:61 `_typeok_chunk_impl`: [B, IW]
# words, bit t set when requirement class b intersects instance type t.
# Bound on an H100: bytes (type rows + class rows, a few hundred KB at the
# headline shape), so launch latency dominates. A CTA stages one 32-type
# word's types and a chunk of class rows in shared memory, builds their key
# masks once, and a warp a row packs its word with __ballot_sync
# (csrc/typeok.cu). The callers hand it their distinct rows only.


def typeok_plain(ireq: Reqs, va: VocabArrays, preq_rows: Reqs, iw: int) -> torch.Tensor:
    """The plain version: pairwise class x type Intersects, packed."""
    a = Reqs(*(x[None] for x in ireq))  # [1, I, ...]
    b = Reqs(*(x[:, None] for x in preq_rows))  # [B, 1, ...]
    return pack(intersects_only(a, b, va), iw)  # [B, IW]


# the Reqs fields the screen reads, and their dtypes
_TYPEOK_FIELDS = ("mask", "other", "notin", "defined", "gt", "lt")
_TYPEOK_DTYPES = (torch.int32, torch.bool, torch.bool, torch.bool, torch.int32, torch.int32)
_TYPEOK_SMEM_MAX = 48 * 1024  # bytes of shared memory a CTA (no opt-in)


class _TypeokTypes(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in _TYPEOK_FIELDS + ("word2key",)] + [
        (n, ctypes.c_int) for n in ("I", "TW", "K")
    ]


class _TypeokRows(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in _TYPEOK_FIELDS + ("out",)] + [
        (n, ctypes.c_int) for n in ("B", "IW", "rb", "cw")
    ]


def _typeok_smem(rb: int, cw: int, k: int) -> int:
    """Shared-memory bytes of one CTA (csrc/typeok.cu `typeok_smem`): the
    types' three key masks (u64 x 32 each), [cw][33] type words, [rb][cw]
    row words, cw word keys, [K][33] type bounds twice, [rb][K] row bounds
    twice and the types' three flag rows, [32 K] bytes each."""
    return 3 * 32 * 8 + 4 * (cw * (33 + rb + 1) + k * (2 * 33 + 2 * rb)) + 3 * 32 * k


@functools.lru_cache(maxsize=None)
def typeok_tiling(n: int, tw: int, k: int) -> tuple[int, int]:
    """(rb, cw) for n class rows: rows a CTA (a warp each, up to the CTA's
    8) and mask words a shared-memory stage: all of TW where they fit the
    CTA's shared memory, else the most that fit. The screen is
    latency-bound, so a CTA takes as many rows as it has warps: fewer CTAs
    share an SM."""
    rb = max(1, min(8, n))
    room = (_TYPEOK_SMEM_MAX - _typeok_smem(rb, 0, k)) // (4 * (33 + rb + 1))
    if room < 1:
        raise ValueError(f"typeok_screen: {k} keys leave no shared memory for mask words")
    return rb, max(1, min(tw, room))


@functools.lru_cache(maxsize=None)
def _typeok_lib():
    lib = _build.library("typeok")
    lib.typeok_types_size.restype = ctypes.c_int
    lib.typeok_rows_size.restype = ctypes.c_int
    lib.typeok_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.typeok_smem_bytes.restype = ctypes.c_size_t
    lib.typeok_screen_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.typeok_screen_launch.restype = ctypes.c_int
    if (lib.typeok_types_size(), lib.typeok_rows_size()) != (ctypes.sizeof(_TypeokTypes), ctypes.sizeof(_TypeokRows)):
        raise _build.DeviceError("typeok_screen: argument layout disagrees with the library")
    if any(lib.typeok_smem_bytes(*a) != _typeok_smem(*a) for a in ((1, 36, 16), (8, 108, 64), (3, 17, 13))):
        raise _build.DeviceError("typeok_screen: shared-memory layout disagrees with the library")
    return lib


class _TypeHalf(NamedTuple):
    """K1's type half: the launch argument and the tensors it points at
    that are not the caller's (the int32 word2key, aligned copies of flag
    rows). Whoever holds it keeps those alive until its launch is queued."""

    args: _TypeokTypes
    owned: tuple


def _typeok_sources(ireq: Reqs, va: VocabArrays) -> tuple:
    return tuple(getattr(ireq, f) for f in _TYPEOK_FIELDS) + (va.word2key,)


_TYPE_HALVES: dict = {}


def _typeok_types(ireq: Reqs, va: VocabArrays, dev: torch.device) -> _TypeHalf:
    """The type half of (ireq, va), built at their first launch and reused
    while those very tensors live (`_tables` screens the class rows and the
    tier rows against the same types). Each type table has its own entry,
    which holds no reference to its sources and goes when the types' mask
    is freed."""
    src = _typeok_sources(ireq, va)
    key = tuple(map(id, src))
    hit = _TYPE_HALVES.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], src)):
        return hit[1]
    Kk = va.num_keys
    if Kk > 64:
        raise ValueError(f"typeok_screen: {Kk} keys exceed the kernel's 64")
    w2k = va.word2key if va.word2key.dtype == torch.int32 else va.word2key.to(torch.int32)
    # the kernel copies the flag rows 4 bytes at a time: a view that does
    # not start on a 4-byte boundary is copied once
    fields = {f: getattr(ireq, f) for f in _TYPEOK_FIELDS}
    for f in ("other", "notin", "defined"):
        if fields[f].data_ptr() % 4:
            fields[f] = fields[f].clone()
    ptrs = {f: K.checked_ptr(fields[f], dt, dev, "i" + f) for f, dt in zip(_TYPEOK_FIELDS, _TYPEOK_DTYPES)}
    args = _TypeokTypes(
        word2key=K.checked_ptr(w2k, torch.int32, dev, "word2key"),
        I=ireq.mask.shape[0], TW=ireq.mask.shape[1], K=Kk, **ptrs,
    )
    half = _TypeHalf(args, tuple(t for t in (w2k, *fields.values()) if not any(t is s for s in src)))
    _TYPE_HALVES[key] = (tuple(weakref.ref(t) for t in src), half)
    weakref.finalize(src[0], _TYPE_HALVES.pop, key, None)
    return half


def typeok_screen(ireq: Reqs, va: VocabArrays, preq_rows: Reqs, iw: int) -> torch.Tensor:
    """[B, IW] int32 words. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    dev = ireq.mask.device
    if dev.type == "cpu":
        return typeok_plain(ireq, va, preq_rows, iw)
    B, TW = preq_rows.mask.shape
    if iw * 32 < ireq.mask.shape[0]:
        raise ValueError(f"typeok_screen: {iw} words cannot hold {ireq.mask.shape[0]} types")
    half = _typeok_types(ireq, va, dev)  # held until the launch is queued
    out = torch.empty((B, iw), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    rb, cw = typeok_tiling(B, TW, half.args.K)
    ptrs = {f: K.checked_ptr(getattr(preq_rows, f), dt, dev, "p" + f) for f, dt in zip(_TYPEOK_FIELDS, _TYPEOK_DTYPES)}
    rows = _TypeokRows(out=out.data_ptr(), B=B, IW=iw, rb=rb, cw=cw, **ptrs)
    code = _typeok_lib().typeok_screen_launch(
        ctypes.byref(half.args), ctypes.byref(rows), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    )
    _build.check_launch("typeok_screen", code)
    LAUNCHES["typeok_screen"] += 1
    return out


# ---------------------------------------------------------------------------
# bulk gates (host side): which pod classes may take the run kernel's bulk
# windows. When a gate fails, every pod takes the exact step inside the
# same kernel, so the gates cost speed, never correctness.


def _popcount_rows(seg: np.ndarray) -> np.ndarray:
    return np.unpackbits(seg.astype("<u4").view(np.uint8), axis=-1).sum(axis=-1)


def _bulk_gates(p: EncodedProblem, strict_types: bool = False) -> bool:
    """Problem-level gates for the bulk windows (the reference's
    `_bulk_gates`): no minValues, no pool limits, no template host ports,
    no reservation offerings, each concrete type row single-valued per key
    or covering the union of the type rows, and offerings whose zone sets
    agree across capacity types.

    strict_types: the per-key type-structure rule. The run kernel verifies
    surviving types exactly at every commit, so its screens need only be
    sound relative to the type universe (the default, the union of the type
    rows). The consolidation sweep's delta kernel has no per-commit verify
    and needs every concrete row single-valued or spanning the whole vocab
    segment (strict_types=True, the reference's default)."""
    if (p.treq.minv != -1).any() or (p.preq_c.minv != -1).any():
        return False
    if p.num_existing and (p.ereq.minv != -1).any():
        return False
    if p.thas_limits.any():
        return False
    if p.thp is not None and p.thp.any():
        return False
    vocab = p.vocab
    for kid in range(vocab.num_keys):
        off, words = vocab.word_offset[kid], vocab.words_per_key[kid]
        seg = p.ireq.mask[:, off : off + words]
        concrete = p.ireq.defined[:, kid] & ~p.ireq.other[:, kid]
        if strict_types:
            full = len(vocab.values[kid])
        else:
            union = np.bitwise_or.reduce(np.where(concrete[:, None], seg, 0), axis=0)
            full = int(_popcount_rows(union[None])[0])
        pop = _popcount_rows(seg)
        if (concrete & (pop > 1) & (pop < full)).any():
            return False
    # offerings decompose per key: every capacity type a type offers covers
    # the same zone set (padded offering rows past num_offerings_real skip)
    per_type: dict[int, dict[int, set]] = {}
    for o in range(p.num_offerings_real):
        i = int(p.otype[o])
        if p.oword[o, 2] != -1:
            return False  # reservation-id offerings
        zw, cw = int(p.oword[o, 0]), int(p.oword[o, 1])
        z = -1 if zw == -1 else zw * 32 + int(p.obit[o, 0])
        c = -1 if cw == -1 else cw * 32 + int(p.obit[o, 1])
        per_type.setdefault(i, {}).setdefault(c, set()).add(z)
    for zones_by_ct in per_type.values():
        wildcard = zones_by_ct.pop(-1, None)
        if wildcard is not None and -1 in wildcard:
            continue  # a fully unconstrained offering covers everything
        sets = [frozenset(v) for v in zones_by_ct.values()]
        if sets and len(set(sets)) > 1 and not any(-1 in s for s in sets):
            return False
    return True


def _bulk_class_flags(p: EncodedProblem, gates_ok: bool) -> np.ndarray:
    """[NC] bool — the class admits bulk windows: the problem gates pass,
    it has no self-selecting zone-family spread/anti constraint, a single
    relax tier and no host ports of its own."""
    NC = len(p.class_reps)
    if not gates_ok:
        return np.zeros(NC, bool)
    dyn_v = np.isin(p.ptopo_kind_c, (TOPO_SPREAD_V, TOPO_ANTI_V)) & p.ptopo_sel_c
    ntiers_c = p.ntiers_r[p.rcls_of]
    has_ports = (
        p.php_own_c.any(axis=1) if p.php_own_c is not None and p.php_own_c.shape[1] else np.zeros(NC, bool)
    )
    return ~dyn_v.any(axis=1) & (ntiers_c == 1) & ~has_ports


# ---------------------------------------------------------------------------
# K4 run_arrays
#
# Replaces karpenter_tpu/solver/tpu.py:155 `_run_arrays`: the run driver
# arrays of a round from its pod index array and the per-class flags. Bound
# on an H100: bytes (a few [P] int arrays, tens of KB at the headline), so
# launch latency decides. One CTA, consecutive threads on consecutive
# positions: the head flags as bit words in shared memory, a block-wide
# reverse min-scan over the words from warp shuffles for the next head, and
# run_rem from the bits (csrc/run_arrays.cu).

_BIG = (1 << 31) - 1


def run_arrays_plain(cls_d, bulk_c, aff_c, idx, n: int):
    """(is_head, bulk, aff, run_rem) [P]. Padding positions (>= n) are
    single-pod runs with bulk off."""
    P = idx.shape[0]
    pos = torch.arange(P, dtype=torch.int32, device=idx.device)
    valid = pos < n
    ci = cls_d[idx.long()].long()
    is_head = (pos == 0) | (ci != torch.roll(ci, 1)) | ~valid
    arr = torch.where(is_head, pos, torch.tensor(_BIG, dtype=torch.int32, device=idx.device))
    m = torch.flip(torch.cummin(torch.flip(arr, (0,)), 0).values, (0,))  # m[i] = min(arr[i:])
    # next head strictly after i; a tail run with no head after it ends at P
    nh = torch.cat([m[1:], torch.tensor([P], dtype=torch.int32, device=idx.device)])
    run_rem = torch.clamp(nh, max=P) - pos
    return is_head, bulk_c[ci] & valid, aff_c[ci] & valid, run_rem


class _RunArraysArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("cls", "bulk_c", "aff_c", "idx", "out")] + [
        (n, ctypes.c_int) for n in ("P", "n", "NCLS", "NC")
    ]


@functools.lru_cache(maxsize=None)
def _small_lib(name: str, args_type):
    lib = _build.library(name)
    getattr(lib, f"{name}_args_size").restype = ctypes.c_int
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    if getattr(lib, f"{name}_args_size")() != ctypes.sizeof(args_type):
        raise _build.DeviceError(f"{name}: argument layout disagrees with the library")
    return lib


def run_arrays(cls_d, bulk_c, aff_c, idx, n: int):
    """run_arrays_plain's contract. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    dev = idx.device
    if dev.type == "cpu":
        return run_arrays_plain(cls_d, bulk_c, aff_c, idx, n)
    P = idx.shape[0]
    if not 0 <= n <= P or bulk_c.shape[0] != aff_c.shape[0]:
        raise ValueError(f"run_arrays: n={n}, P={P}, flags {bulk_c.shape[0]}/{aff_c.shape[0]}")
    ptrs = {
        name: K.checked_ptr(t, dt, dev, name)
        for name, t, dt in (
            ("cls", cls_d, torch.int32), ("bulk_c", bulk_c, torch.bool), ("aff_c", aff_c, torch.bool),
            ("idx", idx, torch.int32),
        )
    }
    out, arrays = _run_arrays_out(P, dev)
    args = _RunArraysArgs(out=out.data_ptr(), P=P, n=n, NCLS=cls_d.shape[0], NC=bulk_c.shape[0], **ptrs)
    lib = _small_lib("run_arrays", _RunArraysArgs)
    code = lib.run_arrays_launch(ctypes.byref(args), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check_launch("run_arrays", code)
    LAUNCHES["run_arrays"] += 1
    return arrays


def _run_arrays_out(P: int, dev: torch.device):
    """(buffer, (is_head, bulk, aff, run_rem)): the kernel's four outputs
    as views of one allocation, run_rem first (4-byte aligned), then the
    three byte arrays; allocated as bool, so that only run_rem needs a
    dtype view."""
    out = torch.empty(7 * P, dtype=torch.bool, device=dev)
    return out, (out[4 * P : 5 * P], out[5 * P : 6 * P], out[6 * P :], out[: 4 * P].view(torch.int32))


# ---------------------------------------------------------------------------
# K5 dedup_rows
#
# Replaces karpenter_tpu/solver/tpu.py:264 `_dedup_decode_state`: claims
# overwhelmingly share identical (requirement row, surviving types) pairs,
# so the decode fetches each distinct row once. Rows are sorted by two
# independent 32-bit row hashes (then by row index: JAX's stable lexsort),
# compared in full with their predecessor, and compacted; hash collisions
# only leave equal rows apart (a duplicate "unique"), never merge distinct
# rows. The kernel reads the rows as the claim state holds them, up to
# nine int32 or bool column blocks side by side (the reference packs them
# first, inside the same jitted program). Bound on an H100: bytes (the
# [n2, C] rows read once, the compact copy and inverse written once: about
# 3 MB at the headline's n2=2048, C=184), in practice a chain of dependent
# phases. Up to 8192 rows it is one launch of a thread-block cluster of up
# to 16 CTAs that shares its phases through distributed shared memory,
# keeps each CTA's rows in its shared memory where they fit and zeroes
# `compact` by bulk copies of the tensor memory accelerator; above, bitonic
# passes over device memory (csrc/dedup_rows.cu). It never calls torch.sort
# or torch.unique.

_MASK32 = 0xFFFFFFFF
# the dedup fetch costs an extra round trip; below this bucket the plain
# slice is cheaper (tests lower it to drive the dedup path on small problems)
_DEDUP_DECODE_MIN = 2048
_DEDUP_MAX_COLS = 9
# the one-launch path's phases, between the clock64 marks of its CTA 0
# (dedup_columns(..., prof=)): a phase ends at the mark after it
DEDUP_PHASES = ("fill", "hash", "local_rank", "barrier_1", "merge", "barrier_2", "mark", "barrier_3", "scan", "scatter")


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32),
    without leaving int64: b is split into 16-bit halves."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def row_hashes(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's two wrapping u32 row hashes of [n, C] int32 rows,
    as int64 tensors in [0, 2^32)."""
    u = rows.to(torch.int64) & _MASK32
    j = torch.arange(rows.shape[1], dtype=torch.int64, device=rows.device)
    m1 = ((2 * j + 1) * 2654435761) & _MASK32
    m2 = ((2 * j + 1) * 2246822519) & _MASK32
    h1 = _mulmod32(u, m1[None]).sum(1) & _MASK32
    h2 = _mulmod32((u + j[None]) & _MASK32, m2[None]).sum(1) & _MASK32
    return h1, h2


def dedup_rows_plain(rows: torch.Tensor):
    """(n_uniq 0-dim int32, inv [n] int32, compact [n, C] int32): the
    unique rows in (h1, h2, index) order at the front of `compact` (zeros
    after), and each row's index among them."""
    n = rows.shape[0]
    h1, h2 = row_hashes(rows)
    order = torch.argsort(h2, stable=True)
    order = order[torch.argsort(h1[order], stable=True)]  # lexsort((h2, h1))
    sm = rows[order]
    is_new = torch.ones(n, dtype=torch.bool, device=rows.device)
    is_new[1:] = torch.any(sm[1:] != sm[:-1], dim=1)
    dest = torch.cumsum(is_new, 0) - 1
    compact = torch.zeros_like(rows)
    compact[dest] = sm  # equal rows share a dest
    inv = torch.zeros(n, dtype=torch.int32, device=rows.device)
    inv[order] = dest.to(torch.int32)
    return (dest[-1] + 1).to(torch.int32), inv, compact


def _packed(cols, n: int) -> torch.Tensor:
    """[n, C] int32: the first n rows of the columns side by side, bools
    widened to 0/1."""
    return torch.cat([c[:n].to(torch.int32) for c in cols], dim=1)


def dedup_columns_plain(cols, n: int):
    """The plain version of dedup_columns: dedup_rows_plain of the packed
    rows."""
    return dedup_rows_plain(_packed(cols, n))


class _DedupCol(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p)] + [(f, ctypes.c_int) for f in ("width", "offset", "is_bool")]


class _DedupArgs(ctypes.Structure):
    _fields_ = (
        [("cols", _DedupCol * _DEDUP_MAX_COLS)]
        + [(f, ctypes.c_int) for f in ("ncols", "n", "C")]
        + [(f, ctypes.c_void_p) for f in ("compact", "inv", "n_uniq", "scratch", "prof")]
    )


@functools.lru_cache(maxsize=None)
def _dedup_lib():
    lib = _small_lib("dedup_rows", _DedupArgs)
    lib.dedup_rows_scratch_bytes.argtypes = [ctypes.c_int]
    lib.dedup_rows_scratch_bytes.restype = ctypes.c_size_t
    return lib


def dedup_columns(cols, n: int, prof: Optional[torch.Tensor] = None):
    """dedup_rows_plain's contract for the rows [n, C] that the first n
    rows of `cols` (up to nine [>= n, w] int32 or bool tensors, contiguous)
    make side by side, bools as 0/1. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which reads the columns in place.
    Up to 8192 rows the launch is one kernel and `prof` (an int64 [11] on
    the device, or None) takes its CTA 0's clock64 at each phase mark
    (`dedup_breakdown`)."""
    dev = cols[0].device
    if dev.type == "cpu":
        return dedup_columns_plain(cols, n)
    if not 1 <= len(cols) <= _DEDUP_MAX_COLS or n < 1:
        raise ValueError(f"dedup_columns: {len(cols)} columns, n={n}")
    if prof is not None and prof.numel() <= len(DEDUP_PHASES):
        raise ValueError(f"dedup_columns: prof holds {prof.numel()} marks, the kernel writes {len(DEDUP_PHASES) + 1}")
    table = (_DedupCol * _DEDUP_MAX_COLS)()
    C = 0
    for c, t in enumerate(cols):
        if t.dim() != 2 or t.shape[0] < n:
            raise ValueError(f"dedup_columns: column {c} has shape {tuple(t.shape)}, expected [>= {n}, w]")
        is_bool = t.dtype == torch.bool
        if n * t.shape[1] * (1 if is_bool else 4) >= 1 << 32:
            raise ValueError(f"dedup_columns: column {c}'s first {n} rows pass 4 GiB (the kernel's offsets are 32-bit)")
        ptr = K.checked_ptr(t, torch.bool if is_bool else torch.int32, dev, f"cols[{c}]")
        table[c] = _DedupCol(ptr, t.shape[1], C, int(is_bool))
        C += t.shape[1]
    # the three outputs as views of one allocation, compact first (16-byte aligned)
    out = torch.empty(n * C + n + 1, dtype=torch.int32, device=dev)
    compact, inv, n_uniq = out[: n * C].view(n, C), out[n * C : n * C + n], out[n * C + n]
    lib = _dedup_lib()
    nbytes = lib.dedup_rows_scratch_bytes(n)  # none up to 8192 rows
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    args = _DedupArgs(
        cols=table, ncols=len(cols), n=n, C=C, compact=compact.data_ptr(), inv=inv.data_ptr(),
        n_uniq=n_uniq.data_ptr(), scratch=scratch.data_ptr() if nbytes else None,
        prof=K.checked_ptr(prof, torch.int64, dev, "prof") if prof is not None else None,
    )
    code = lib.dedup_rows_launch(ctypes.byref(args), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check_launch("dedup_rows", code)
    LAUNCHES["dedup_rows"] += 1
    return n_uniq, inv, compact


def dedup_breakdown(prof: torch.Tensor) -> dict:
    """{phase: cycles} of a one-launch dedup_columns(..., prof=) run on its
    CTA 0 (DEDUP_PHASES), and "total"."""
    marks = prof.tolist()
    out = {p: marks[i + 1] - marks[i] for i, p in enumerate(DEDUP_PHASES)}
    out["total"] = marks[-1] - marks[0]
    return out


def dedup_rows(rows: torch.Tensor):
    """dedup_rows_plain's contract; CUDA tensors launch the kernel."""
    return dedup_columns([rows], rows.shape[0])


# ---------------------------------------------------------------------------
# The launch floor (csrc/empty.cu): a kernel that does nothing, launched as
# the wrappers above launch theirs. No solve runs it; chip_smoke.py and
# tools/torch_compare.py time it beside K1, K4 and K5.


@functools.lru_cache(maxsize=None)
def _empty_lib():
    lib = _build.library("empty")
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def empty_launch(dev: torch.device) -> None:
    """Launch the empty kernel on `dev`'s current stream."""
    code = _empty_lib().empty_launch(ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check_launch("empty", code)


def decode_columns(st: K.State) -> list:
    """The claim state's columns in the reference's dedup layout: the
    requirement row's eight fields, then the surviving types (C = 2 TW +
    6 K + IW)."""
    return [*st.creq, st.alive]


def decode_rows(st: K.State, n2: int) -> torch.Tensor:
    """[n2, C] int32: each live claim slot's requirement row and surviving
    types packed side by side."""
    return _packed(decode_columns(st), n2)


def dedup_decode_state(st: K.State, n2: int):
    """(n_uniq, inv, compact) of the first n2 claim rows, read where the
    state holds them; compact stays on the device until the caller knows
    n_uniq (`_slice_rows`)."""
    return dedup_columns(decode_columns(st), n2)


# ---------------------------------------------------------------------------
# the per-solve odometer


def _new_odo_totals() -> dict:
    """Per-solve kernel-odometer accumulator (TorchScheduler.last_odometer):
    dispatch counters sum over every kernel launch of the solve, including
    a scan-path attempt that overflowed and was re-solved;
    claims_opened/claim_slots/claim_occupancy land in _decode."""
    return {
        "steps": 0,
        "bulk_steps": 0,
        "tier_steps": 0,
        "tier_hist": [0] * K.ODO_TIER_BINS,
        "dispatches": 0,
        "overflow_signals": 0,
        "regrows": 0,
    }


def _odo_dispatch_dict(odo: K.Odometer) -> dict:
    """One fetched kernel Odometer as plain ints: the `kernel` block a
    dispatch span carries and the unit the per-solve totals accumulate."""
    d = {"steps": int(odo.steps), "bulk_steps": int(odo.bulk_steps), "tier_steps": int(odo.tier_steps)}
    if d["tier_steps"]:
        d["tier_hist"] = [int(v) for v in odo.tier_hist.tolist()]  # a host array or a device tensor
    return d


def _fold_odo(totals: dict, odo, path: Optional[str] = None) -> dict:
    """Fold one dispatch's odometer (a K.Odometer, or an accumulator such
    as a fleet lane's) into the solve totals and, with `path`, into the
    labeled kernel metrics; returns the folded block."""
    d = odo if isinstance(odo, dict) else _odo_dispatch_dict(odo)
    totals["steps"] += d.get("steps", 0)
    totals["bulk_steps"] += d.get("bulk_steps", 0)
    totals["tier_steps"] += d.get("tier_steps", 0)
    for t, v in enumerate(d.get("tier_hist", ())):
        totals["tier_hist"][t] += v
    totals["dispatches"] += d.get("dispatches", 1)
    for k in ("overflow_signals", "regrows"):
        totals[k] += d.get(k, 0)
    if path is not None:
        if d.get("steps"):
            tracing.KERNEL_ITERATIONS.inc({"path": path}, by=d["steps"])
        for t, v in enumerate(d.get("tier_hist", ())):
            if v:
                tracing.KERNEL_TIER_STEPS.inc({"tier": str(t)}, by=v)
    return d


def _tree_nbytes(tree) -> int:
    """Total bytes across the tensors of a table set (NamedTuples, dicts,
    tuples of tensors): the table-upload accounting behind
    karpenter_solve_upload_bytes_total."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_nbytes(v) for v in tree)
    return 0


# the solve driver's top-level phases, as its trace names them
SOLVE_PHASES = ("encode", "order", "upload", "fleet_dispatch", "dispatch", "regrow", "decode")


# ---------------------------------------------------------------------------

_DecodeView = collections.namedtuple(
    "_DecodeView",
    ["n_claims", "creq", "crequests", "alive", "tmpl", "eavail", "ereq", "v_cnt", "h_cnt"],
)


def _np_words(t: torch.Tensor) -> np.ndarray:
    """int32 bit words on any device -> host uint32 (the same bits)."""
    return t.cpu().numpy().view(np.uint32)


class TorchScheduler:
    """Same surface as oracle.Scheduler, solving with torch on `device`
    (None = the CUDA device; pass "cpu" for the plain versions)."""

    # Testing knob: take the exact per-pod scan path even when a class
    # passes the bulk gates. The scan path is always valid (the runs path
    # only cuts iterations), so forcing it re-checks the same decisions
    # through the other kernel. The reference has the same knob.
    debug_force_scan = False

    def __init__(
        self,
        node_pools: list[NodePool],
        instance_types_by_pool: dict,
        topology: Topology,
        state_nodes: Optional[list[StateNodeView]] = None,
        daemonset_pods: Optional[list[Pod]] = None,
        options: Optional[SchedulerOptions] = None,
        device=None,
        fleet=None,
        table_cache=None,
        epoch_key=None,
    ):
        self.device = resolve_device(device)
        # reuse the oracle's init wholesale: template filtering, daemon
        # overhead, existing-node ordering, limits
        self.oracle = Scheduler(
            node_pools, instance_types_by_pool, topology, state_nodes, daemonset_pods, options
        )
        self.opts = self.oracle.opts
        # fleet.FleetCoalescer (optional): scan-path solves offer themselves
        # to its batch window and ride shared lane dispatches when siblings
        # arrive; any None answer (no sibling, overflow, coalescing fault)
        # runs the solo loop unchanged
        self.fleet = fleet
        # epochs.DeviceTableCache (optional, shared across schedulers — the
        # sidecar server owns one): table sets on the card keyed by the
        # content fingerprint of every encoded array they derive from. A
        # hit skips _tables/_upload_pod_tables and the type screens, so a
        # repeat same-epoch solve uploads only the pending-pod batch
        self._table_cache = table_cache
        # (client, epoch id) of the request this scheduler serves, when the
        # sidecar materialized it from a resident epoch: rides the fleet
        # window's trace event
        self._epoch_key = epoch_key
        # the last solve's kernel odometer (see _new_odo_totals), path,
        # whether the tier loop ran, its trace (`last_profile`) and its
        # host phases in seconds, read off that trace (SOLVE_PHASES)
        self.last_odometer = None
        self.last_used_runs = False
        self.last_used_fleet = False
        self.last_relax = False
        self.last_profile = None
        self.last_phases = {}
        # the fleet window of the last solve (mode, lanes, rounds,
        # wait_seconds; set by the coalescer), None when it offered none
        self.last_fleet = None

    # -- solve ----------------------------------------------------------

    def solve(self, pods: list[Pod], trace=None) -> Results:
        """May raise tpu_problem.UnsupportedBySolver (an encode gate);
        callers fall back to the oracle.

        `trace` is an optional tracing.Trace the caller threads down from
        the controller; a standalone solve owns a local one, so the phase
        metrics populate on every solve. `last_profile` is that trace and
        `last_phases` this solve's share of its phases."""
        with tracing.maybe_trace(trace, "tpu_solve") as tr:
            self.last_profile = tr
            before = tr.phases
            try:
                return self._solve_traced(pods, tr)
            finally:
                after = tr.phases
                self.last_phases = {
                    k: after[k] - before.get(k, 0.0) for k in SOLVE_PHASES if k in after
                }

    def _upload(self, problem: EncodedProblem, prof):
        """The upload phase: (tb, table fingerprint or None, upload bytes).
        Sets `_typeok`, `_dev_tables` and `_aff_c`. With a table cache, a
        problem-fingerprint hit takes all four from the card as they lie
        (no bytes, no type screen); a table-fingerprint hit takes the
        shared K.Tables and rebuilds only the pod tables; a miss builds
        both and publishes them."""
        cache = self._table_cache
        cached = None
        fp = tfp = None
        if cache is not None:
            fp = problem_fingerprint(problem)
            cached = cache.get(fp)
        if cached is not None:
            tb, self._typeok, self._dev_tables, self._aff_c = cached
            prof.event("table_cache", outcome="hit")
            return tb, tfp, 0
        tb = token = None
        if cache is not None:
            # single-flight on the TABLE fingerprint: concurrent same-epoch
            # solves (a fleet window's lanes all encoding before any put
            # lands) elect one builder for the shared K.Tables; the rest
            # block here and reuse it
            tfp = table_fingerprint(problem)
            tb, token = cache.begin_tables(tfp)
        try:
            if tb is not None:
                self._typeok = self._pod_typeok(problem, tb.ireq, tb.va)
                self._upload_pod_tables(problem)
                upload_bytes = _tree_nbytes(self._dev_tables)
                prof.event("table_cache", outcome="tables_hit")
            else:
                tb = self._tables(problem)  # also sets self._typeok
                self._upload_pod_tables(problem)
                upload_bytes = _tree_nbytes(tb) + _tree_nbytes(self._dev_tables)
                if cache is not None:
                    prof.event("table_cache", outcome="miss")
        finally:
            if cache is not None:
                cache.end_tables(token, tb)
        if cache is not None:
            cache.put(fp, (tb, self._typeok, self._dev_tables, self._aff_c))
        return tb, tfp, upload_bytes

    def _solve_traced(self, pods: list[Pod], prof) -> Results:
        if not pods:
            return Results(new_node_claims=[], existing_nodes=self.oracle.existing_nodes, pod_errors={})
        with prof.span("encode", pods=len(pods)):
            problem = encode_problem(self.oracle, pods)
        deadline = (
            time_mod.monotonic() + self.opts.timeout_seconds if self.opts.timeout_seconds else None
        )
        with prof.span("order"):
            order = self._order_pods(problem)
        with prof.span("upload"):
            tb, tfp, upload_bytes = self._upload(problem, prof)
            self._bulk_flags_c = _bulk_class_flags(problem, _bulk_gates(problem))
        if upload_bytes:
            prof.count("upload_bytes", by=upload_bytes)
            tracing.SOLVE_UPLOAD_BYTES.inc(by=upload_bytes)
        # with no relaxable requirement class the kernels run without the
        # tier loop, exactly as for a preference-free problem
        relax = bool((problem.ntiers_r > 1).any())
        self.last_relax = relax
        use_runs = bool(self._bulk_flags_c.any()) and not self.debug_force_scan
        self.last_used_runs = use_runs
        if use_runs:
            self._set_runflags_dev()

        # Claim slots start small: the runs path grows the carried state on
        # overflow and goes on from the overflowing pod (decisions do not
        # depend on the slot count), so it risks only a growth step. The
        # scan path re-solves from scratch, so its pool is not undersized.
        div = max(1, int(self.opts.claim_slot_div))
        if not use_runs:
            div = min(div, 4)
        N = min(_pow2(max(64, (len(pods) + div - 1) // div)), _pow2(len(pods)))
        # the bucket is a decision, not a duration: a marker of the path x
        # claim-slot rung x relax this solve rode
        path = "runs" if use_runs else "scan"
        prof.event("bucket", claim_slots=N, path=path, relax=relax)
        tiers_beyond_0 = int(problem.ntiers_r.max(initial=1)) - 1 if relax else 0
        if tiers_beyond_0:
            prof.count("relax_tiers", by=tiers_beyond_0)
            tracing.SOLVE_RELAX_TIERS.inc(by=tiers_beyond_0)
        odo = _new_odo_totals()
        self.last_odometer = odo
        # fleet coalescing (solver/fleet.py): the scan path only, as in the
        # reference; the runs path's mid-round regrow is per lane
        self.last_used_fleet = False
        self.last_fleet = None
        if self.fleet is not None and not use_runs:
            got = self.fleet.solve_lane(
                self, problem, tb, order, N, relax, deadline, trace=prof, table_fp=tfp, epoch_key=self._epoch_key
            )
            if got is not None:
                st, kinds, slots, timed_out, lane_odo = got
                self.last_used_fleet = True
                _fold_odo(odo, lane_odo, "fleet")
                prof.count("kernel_iterations", by=lane_odo.get("steps", 0))
                if lane_odo.get("tier_steps"):
                    prof.count("kernel_tier_steps", by=lane_odo["tier_steps"])
                prof.annotate(pods=len(pods), path="fleet", relax=relax, claim_slots=N, timed_out=timed_out)
                with prof.span("decode"):
                    return self._decode(problem, st, kinds, slots, timed_out)
        while True:
            st = self._init_state(problem, N)
            seq = torch.zeros(N, dtype=torch.int32, device=self.device)
            next_seq = torch.zeros((), dtype=torch.int32, device=self.device)
            kinds = np.full(len(pods), K.KIND_FAIL, dtype=np.int32)
            slots = np.full(len(pods), -1, dtype=np.int32)
            pending = list(order)
            timed_out = False
            overflowed = False
            while pending:
                if deadline is not None and time_mod.monotonic() > deadline:
                    timed_out = True
                    break
                # one requeue round over `pending`; the runs path takes one
                # more dispatch per claim-slot growth inside the round
                round_failed: list[int] = []
                offset = 0
                while True:
                    batch = pending[offset:]
                    # one dispatch: the round's rows, the kernel launch, and
                    # one fetch of the verdicts with the odometer block; the
                    # sub-spans are recorded only behind the detail gate
                    with prof.span("dispatch", path=path) as dsp:
                        if use_runs:
                            with prof.span("pod_xs", detail=True):
                                xs, idx_d = self._pod_xs_with_idx(problem, batch)
                                rx = self._run_x(xs, idx_d, len(batch))
                            with prof.span("kernel", detail=True):
                                st, seq, next_seq, got_kinds, got_slots, got_over, got_odo, got_ptr = KR.solve_runs(
                                    tb, st, rx, seq, next_seq, len(batch), relax
                                )
                        else:
                            with prof.span("pod_xs", detail=True):
                                xs = self._pod_xs(problem, batch)
                            with prof.span("kernel", detail=True):
                                st, got_kinds, got_slots, got_over, got_odo = K.solve_scan(tb, st, xs, relax)
                                got_ptr = None
                        with prof.span("fetch", detail=True):
                            got_kinds = got_kinds.cpu().numpy()
                            got_slots = got_slots.cpu().numpy()
                            got_over = bool(got_over)
                            dsp["kernel"] = _fold_odo(odo, got_odo, path)
                    prof.count("dispatches")
                    tracing.SOLVE_DISPATCHES.inc({"path": path})
                    if got_over:
                        odo["overflow_signals"] += 1
                        tracing.KERNEL_OVERFLOWS.inc({"path": path})
                    if got_over and got_ptr is None:
                        overflowed = True  # scan path: re-solve from scratch
                        break
                    # runs path: commit the pods before the overflowing one,
                    # grow the state, go on from that pod
                    n_done = int(got_ptr) if got_over else len(batch)
                    done = batch[:n_done]
                    kinds[done] = got_kinds[:n_done]
                    slots[done] = got_slots[:n_done]
                    round_failed += [i for i, k in zip(done, got_kinds[:n_done]) if k == K.KIND_FAIL]
                    if not got_over:
                        break
                    with prof.span("regrow"):
                        st, seq = self._grow(problem, st, seq, N)
                    prof.count("regrows")
                    tracing.SOLVE_REGROWS.inc()
                    odo["regrows"] += 1
                    N *= 2
                    offset += n_done
                if overflowed:
                    break
                if len(round_failed) == len(pending):
                    break  # no progress: stall
                pending = round_failed
            if not overflowed:
                break
            N *= 2  # scan-path slots exhausted: re-solve with room
        prof.count("kernel_iterations", by=odo["steps"])
        if odo["tier_steps"]:
            prof.count("kernel_tier_steps", by=odo["tier_steps"])
        prof.annotate(pods=len(pods), path=path, relax=relax, claim_slots=N, timed_out=timed_out)
        with prof.span("decode"):
            return self._decode(problem, st, kinds, slots, timed_out)

    def _order_pods(self, p: EncodedProblem) -> list:
        """FFD order from class columns; also points cached_pod_data at one
        shared PodData per class."""
        from karpenter_tpu_torch.solver.ordering import ffd_order_cols, pod_class_signature

        pods = p.pods
        data = self.oracle.cached_pod_data
        pd_c = []
        for i in p.class_reps:
            self.oracle._update_cached_pod_data(pods[i])
            pd_c.append(data[pods[i].uid])
        for pod, c in zip(pods, p.pod_class.tolist()):
            data[pod.uid] = pd_c[c]
        cpu_c = np.fromiter((pd.requests.get(res.CPU, 0) for pd in pd_c), np.int64, len(pd_c))
        mem_c = np.fromiter((pd.requests.get(res.MEMORY, 0) for pd in pd_c), np.int64, len(pd_c))
        sig_c = np.fromiter(
            (pod_class_signature(pods[i]) for i in p.class_reps), np.int64, len(p.class_reps)
        )
        cls = p.pod_class
        ts_list = [pod.metadata.creation_timestamp for pod in pods]
        uids = [pod.uid for pod in pods]
        return ffd_order_cols(cpu_c[cls], mem_c[cls], sig_c[cls], ts_list, uids)

    def _cr_padded(self, p: EncodedProblem) -> np.ndarray:
        """[NR_pad] class index per requirement class, bucket-padded by
        repeating real rows (pad rows are never gathered)."""
        cr = np.asarray(p.rclass_creps, dtype=np.int64)
        if not buckets.enabled() or len(cr) == 0:
            return cr
        return cr[np.arange(buckets.bucket(len(cr))) % len(cr)]

    def _class_rows(self, p: EncodedProblem) -> Reqs:
        """The NR requirement classes' rows, one a class: what
        `_pod_typeok` screens."""
        cr = np.asarray(p.rclass_creps, dtype=np.int64)
        return Reqs(*(to_tensor(a[cr], self.device) for a in p.preq_c))

    def _pod_typeok(self, p: EncodedProblem, ireq: Reqs, va: VocabArrays) -> torch.Tensor:
        """[NR_pad, IW] words — per requirement class, the instance types
        whose requirements intersect the class's (the pairwise screen; the
        step stays exact for three-way intersections, offerings and
        minValues). The NR classes are screened once and the bucket's pad
        rows repeat them, as `_cr_padded` does."""
        IW = max(1, (p.num_types + 31) // 32)
        NR, NR_pad = len(p.rclass_creps), len(self._cr_padded(p))
        if NR == 0:
            return torch.zeros((0, IW), dtype=torch.int32, device=self.device)
        out = typeok_screen(ireq, va, self._class_rows(p), IW)
        return out if NR_pad == NR else out.repeat(-(-NR_pad // NR), 1)[:NR_pad]

    def _tier_rows(self, p: EncodedProblem) -> Optional[Reqs]:
        """The NRx*L tier rows of the relaxable requirement classes (None
        with nothing to relax)."""
        if not p.rt_tier_reqs:
            return None
        n = len(p.rt_tier_reqs) * p.num_tiers
        return Reqs(*(to_tensor(a.reshape((n,) + a.shape[2:]), self.device) for a in p.rt_preq))

    def _tier_typeok(self, p: EncodedProblem, ireq: Reqs, va: VocabArrays) -> torch.Tensor:
        """[NRx_pad, L, IW] words — per relaxable requirement class and
        tier, the pairwise pod x type screen (the tier rows of
        `_pod_typeok`), in one `typeok_screen` launch over `_tier_rows`; the
        NRx axis is bucketed with zero rows like the other tier tables."""
        IW = max(1, (p.num_types + 31) // 32)
        rows = self._tier_rows(p)
        if rows is None:
            out = torch.zeros((1, 1, IW), dtype=torch.int32, device=self.device)
        else:
            NRx, L = len(p.rt_tier_reqs), p.num_tiers
            out = typeok_screen(ireq, va, rows, IW).reshape(NRx, L, IW)
        if buckets.enabled():
            n_pad = buckets.bucket(out.shape[0], floor=1) - out.shape[0]
            if n_pad > 0:
                out = torch.cat([out, out.new_zeros((n_pad,) + out.shape[1:])])
        return out

    # -- tensor construction --------------------------------------------

    def _t(self, a) -> torch.Tensor:
        return to_tensor(np.asarray(a), self.device)

    def _reqs(self, r: Reqs) -> Reqs:
        return Reqs(*(self._t(a) for a in r))

    def _tables(self, p: EncodedProblem) -> K.Tables:
        t = self._t

        def pad_group_v(a, fill=0):
            if a.shape[0] == 0:
                return t(np.full((1,) + a.shape[1:], fill, dtype=a.dtype))
            return t(a)

        def pad_rt(a):
            """Bucket the relaxable-class axis of the tier tables (rows past
            the real count are never gathered: rrow holds real ids only)."""
            if not buckets.enabled():
                return a
            return buckets.pad_rows(a, buckets.bucket(a.shape[0], floor=1))

        Gv, Gh = len(p.vgroups), len(p.hgroups)
        v_anti = np.array([g.group.type.value == 2 for g in p.vgroups], dtype=bool).reshape(Gv)
        h_inverse = np.array([g.inverse for g in p.hgroups], dtype=bool).reshape(Gh)
        va = VocabArrays.from_vocab(p.vocab, self.device)
        ireq = self._reqs(p.ireq)
        self._typeok = self._pod_typeok(p, ireq, va)
        return K.Tables(
            va=va,
            treq=self._reqs(p.treq),
            tdaemon=t(p.tdaemon),
            ttypes=t(p.ttypes),
            tlimit_def=t(p.tlimit_def),
            thas_limits=t(p.thas_limits),
            ireq=ireq,
            ialloc=t(p.ialloc),
            icap=t(p.icap),
            otype=t(p.otype),
            oword=t(p.oword),
            obit=t(p.obit),
            orid=t(p.orid if p.orid is not None else np.full(p.otype.shape[0], -1, np.int32)),
            ovalid=t(p.ovalid if p.ovalid is not None else np.ones(p.otype.shape[0], bool)),
            v_kid=pad_group_v(p.v_kid),
            v_word=pad_group_v(p.v_word, fill=-1),
            v_bit=pad_group_v(p.v_bit),
            v_reg=pad_group_v(p.v_reg, fill=False),
            v_skew=pad_group_v(p.v_skew),
            v_mindom=pad_group_v(p.v_mindom, fill=-1),
            v_filt=pad_group_v(p.v_filt, fill=-1),
            v_anti=pad_group_v(v_anti, fill=False),
            h_skew=pad_group_v(p.h_skew),
            h_filt=pad_group_v(p.h_filt, fill=-1),
            h_inverse=pad_group_v(h_inverse, fill=False),
            filter_reqs=self._reqs(p.filter_reqs),
            thp=t(p.thp if p.thp is not None else np.zeros((p.num_templates, 0), np.uint32)),
            rt_preq=Reqs(*(t(pad_rt(a)) for a in p.rt_preq)),
            rt_typeok=self._tier_typeok(p, ireq, va),
            rt_tol_t=t(pad_rt(p.rt_tol_t)),
            rt_tol_e=t(pad_rt(p.rt_tol_e)),
            rt_kind=t(pad_rt(p.rt_kind)),
            rt_gid=t(pad_rt(p.rt_gid)),
            rt_sel=t(pad_rt(p.rt_sel)),
        )

    def _init_state(self, p: EncodedProblem, N: int) -> K.State:
        dev = self.device
        R = p.table.num_resources
        IW = max(1, (p.num_types + 31) // 32)
        E = p.num_existing
        Gh = max(len(p.hgroups), 1)
        S = E + N
        v_cnt = p.v_cnt if len(p.vgroups) else np.zeros((1, p.vmax or 1), np.int32)
        h_cnt = np.zeros((Gh, S), np.int32)
        for g, slot, c in p.h_seed:
            h_cnt[g, slot] += c
        i32 = torch.int32
        ehp = p.ehp if p.ehp is not None else np.zeros((E, 0), np.uint32)
        hpw = (p.num_host_ports + 31) // 32
        return K.State(
            active=torch.zeros(N, dtype=torch.bool, device=dev),
            count=torch.zeros(N, dtype=i32, device=dev),
            rank=torch.zeros(N, dtype=i32, device=dev),
            tmpl=torch.zeros(N, dtype=i32, device=dev),
            creq=self._reqs(empty_reqs(p.vocab, (N,))),
            crequests=torch.zeros((N, R), dtype=i32, device=dev),
            alive=torch.zeros((N, IW), dtype=i32, device=dev),
            cmax_alloc=torch.zeros((N, R), dtype=i32, device=dev),
            n_claims=torch.zeros((), dtype=i32, device=dev),
            ereq=self._reqs(p.ereq),
            eavail=self._t(p.eavail),
            trem=self._t(p.tlimit_rem),
            v_cnt=self._t(v_cnt),
            h_cnt=self._t(h_cnt),
            rescap=self._t(p.rescap0 if p.rescap0 is not None else np.zeros(0, np.int32)),
            held=torch.zeros((N, (p.num_reservations + 31) // 32), dtype=i32, device=dev),
            hp_used=torch.cat([self._t(ehp), torch.zeros((N, hpw), dtype=i32, device=dev)]),
        )

    def _upload_pod_tables(self, p: EncodedProblem) -> None:
        """Pod tables on the device once per solve; a round's batch is then
        an index array. Heavy rows live per requirement class, request
        vectors and inverse rows per encode class, selection rows per
        unique (namespace, labels)."""
        t = self._t
        cr = self._cr_padded(p)
        Gv = max(len(p.vgroups), 1)
        Gh = max(len(p.hgroups), 1)

        def pad_g(a, G):
            return a if a.shape[1] == G else np.zeros((a.shape[0], G), a.dtype)

        if buckets.enabled():
            NC_pad = buckets.bucket(p.prequests_c.shape[0])
            U_pad = buckets.bucket(p.sel_rows_v.shape[0])
        else:
            NC_pad = p.prequests_c.shape[0]
            U_pad = p.sel_rows_v.shape[0]
        pad_c = lambda a: buckets.pad_rows(a, NC_pad)
        pad_u = lambda a: buckets.pad_rows(a, U_pad)
        NR_pad = max(len(cr), 1)
        self._dev_tables = dict(
            preq_r=Reqs(*(t(a[cr]) for a in p.preq_c)),
            typeok_r=self._typeok,
            tol_t_r=t(p.ptol_t_c[cr]),
            tol_e_r=t(p.ptol_e_c[cr]),
            kind_r=t(p.ptopo_kind_c[cr]),
            gid_r=t(p.ptopo_gid_c[cr]),
            tsel_r=t(p.ptopo_sel_c[cr]),
            rcls_of=t(pad_c(p.rcls_of).astype(np.int64)),
            prequests_c=t(pad_c(p.prequests_c)),
            cls=t(np.asarray(p.pod_class, dtype=np.int32)),
            srow=t(np.asarray(p.srow, dtype=np.int64)),
            sel_rows_v=t(pad_u(pad_g(p.sel_rows_v, Gv))),
            sel_rows_h=t(pad_u(pad_g(p.sel_rows_h, Gh))),
            inv_c=t(pad_c(pad_g(p.pinv_h_c, Gh))),
            own_c=t(pad_c(pad_g(p.pown_h_c, Gh))),
            hp_own_r=t(p.php_own_c[cr]),
            hp_conf_r=t(p.php_conf_c[cr]),
            ntiers_r=t(buckets.pad_rows(p.ntiers_r, NR_pad, fill=1)),
            rrow_r=t(buckets.pad_rows(p.rrow_of_rcls, NR_pad)),
        )
        # classes owning a pod-affinity constraint: their run head commits
        # through the exact step before the run cache builds
        self._aff_c = np.isin(p.ptopo_kind_c, (TOPO_AFFINITY_V, TOPO_AFFINITY_H)).any(axis=1)

    def _pod_xs_with_idx(self, p: EncodedProblem, indices: list[int], pad_to: int = 0):
        """(PodX, idx_d): one round's PodX rows (pow2-padded, or to
        `pad_to` when that is larger: a fleet window pads every lane to its
        shared rung so the lanes stack; pads carry pod 0's rows with
        valid=False), gathered on the device from the round's one upload,
        the int32 index array idx_d, which the run driver arrays
        (`_run_x`) derive from too."""
        d = self._dev_tables
        n = len(indices)
        P_pad = max(_pow2(n), pad_to)
        idx = np.zeros(P_pad, dtype=np.int32)
        idx[:n] = indices
        idx_d = torch.from_numpy(idx).to(self.device)
        ii = idx_d.long()
        ci = d["cls"][ii].long()
        ri = d["rcls_of"][ci]
        si = d["srow"][ii]
        xs = K.PodX(
            preq=Reqs(*(a[ri] for a in d["preq_r"])),
            prequests=d["prequests_c"][ci],
            typeok=d["typeok_r"][ri],
            tol_t=d["tol_t_r"][ri],
            tol_e=d["tol_e_r"][ri],
            topo_kind=d["kind_r"][ri],
            topo_gid=d["gid_r"][ri],
            topo_sel=d["tsel_r"][ri],
            sel_v=d["sel_rows_v"][si],
            sel_h=d["sel_rows_h"][si],
            inv_h=d["inv_c"][ci],
            own_h=d["own_c"][ci],
            valid=torch.arange(P_pad, device=self.device) < n,
            rrow=d["rrow_r"][ri],
            ntiers=d["ntiers_r"][ri],
            hp_own=d["hp_own_r"][ri],
            hp_conf=d["hp_conf_r"][ri],
        )
        return xs, idx_d

    def _pod_xs(self, p: EncodedProblem, indices: list[int]) -> K.PodX:
        return self._pod_xs_with_idx(p, indices)[0]

    def _set_runflags_dev(self) -> None:
        """The per-class bulk/affinity flags on the device, padded in step
        with the class tables."""
        nc = self._dev_tables["prequests_c"].shape[0]
        self._runflags_dev = (
            self._t(buckets.pad_rows(self._bulk_flags_c, nc)),
            self._t(buckets.pad_rows(self._aff_c, nc)),
        )

    def _run_x(self, xs: K.PodX, idx_d: torch.Tensor, n: int) -> KR.RunX:
        """The run driver arrays of a round, on the device from the round's
        index array (`run_arrays`, kernel K4 on the card)."""
        bulk_d, aff_d = self._runflags_dev
        is_head, bulk, aff, run_rem = run_arrays(self._dev_tables["cls"], bulk_d, aff_d, idx_d, n)
        return KR.RunX(x=xs, is_head=is_head, bulk=bulk, aff=aff, run_rem=run_rem)

    def _grow(self, p: EncodedProblem, st: K.State, seq: torch.Tensor, N: int):
        """Pad the carried state from N to 2N claim slots (the runs path's
        overflow continuation): the new rows are _init_state's inert
        slots, appended after the old ones."""
        dev = self.device
        i32 = torch.int32

        def cat(a, b, dim=0):
            return torch.cat([a, b], dim=dim)

        pad_req = self._reqs(empty_reqs(p.vocab, (N,)))
        zeros = lambda *shape, dtype=i32: torch.zeros(shape, dtype=dtype, device=dev)
        st = st._replace(
            active=cat(st.active, zeros(N, dtype=torch.bool)),
            count=cat(st.count, zeros(N)),
            rank=cat(st.rank, zeros(N)),
            tmpl=cat(st.tmpl, zeros(N)),
            creq=Reqs(*(cat(a, b) for a, b in zip(st.creq, pad_req))),
            crequests=cat(st.crequests, zeros(N, st.crequests.shape[1])),
            alive=cat(st.alive, zeros(N, st.alive.shape[1])),
            cmax_alloc=cat(st.cmax_alloc, zeros(N, st.cmax_alloc.shape[1])),
            h_cnt=cat(st.h_cnt, zeros(st.h_cnt.shape[0], N), dim=1),
            held=cat(st.held, zeros(N, st.held.shape[1])),
            hp_used=cat(st.hp_used, zeros(N, st.hp_used.shape[1])),
        )
        return st, cat(seq, zeros(N))

    # -- decoding --------------------------------------------------------

    def _decode(self, p: EncodedProblem, st: K.State, kinds, slots, timed_out: bool) -> Results:
        vocab, table = p.vocab, p.table
        scheduler = self.oracle
        n_claims = int(st.n_claims)
        N = st.active.shape[0]
        if self.last_odometer is not None:
            occupancy = (n_claims / N) if N else 0.0
            self.last_odometer.update(claims_opened=n_claims, claim_slots=N, claim_occupancy=round(occupancy, 4))
            tracing.KERNEL_CLAIMS_OPENED.inc(by=n_claims)
            tracing.KERNEL_CLAIM_OCCUPANCY.observe(occupancy)
        # fetch only the live claim rows (pow2-bucketed)
        n2 = min(_pow2(max(n_claims, 1), floor=64), N)
        E = st.eavail.shape[0]
        word_fields = ("mask", "exmask")

        def host_reqs(r: Reqs, rows) -> Reqs:
            return Reqs(
                *(
                    _np_words(a[rows]) if f in word_fields else a[rows].cpu().numpy()
                    for f, a in zip(Reqs._fields, r)
                )
            )

        if n2 >= _DEDUP_DECODE_MIN:
            # big solve: fetch each distinct (requirement row, surviving
            # types) pair once, then rematerialize through the inverse index
            n_uniq, inv, compact = dedup_decode_state(st, n2)
            u2 = min(_pow2(max(int(n_uniq), 1), floor=64), n2)
            uniq = _np_words(compact[:u2])
            TW, Kk = vocab.total_words, vocab.num_keys
            cuts = np.cumsum([0, TW, TW, Kk, Kk, Kk, Kk, Kk, Kk])
            cols = [uniq[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
            # columns come back as uint32: word fields stay so, bounds are
            # int32 bits, flags are 0/1
            as_field = {"gt": np.int32, "lt": np.int32, "minv": np.int32}
            inv = inv.cpu().numpy()
            creq = Reqs(
                *(
                    np.ascontiguousarray(
                        (c if f in word_fields else c.view(as_field[f]) if f in as_field else c.astype(bool))[inv]
                    )
                    for f, c in zip(Reqs._fields, cols)
                )
            )
            alive = np.ascontiguousarray(uniq[:, cuts[-1] :][inv])
        else:
            creq = host_reqs(st.creq, slice(0, n2))
            alive = _np_words(st.alive[:n2])
        tmpl = st.tmpl[:n2].cpu().numpy()
        crequests = st.crequests[:n2].cpu().numpy()
        eavail = st.eavail.cpu().numpy()
        ereq = host_reqs(st.ereq, slice(None))
        v_cnt = st.v_cnt.cpu().numpy()
        h_cnt = st.h_cnt[:, : E + n2].cpu().numpy()
        trem = st.trem.cpu().numpy()

        # global type table order (same construction as encode_problem)
        type_idx: dict[int, int] = {}
        for nct in scheduler.templates:
            for it in nct.instance_type_options:
                if id(it) not in type_idx:
                    type_idx[id(it)] = len(type_idx)
        alive_bits = np.unpackbits(
            np.ascontiguousarray(alive[:n_claims]).astype("<u4").view(np.uint8),
            axis=-1,
            bitorder="little",
        )
        ordered_types = [None] * len(type_idx)
        for it_id, i in type_idx.items():
            ordered_types[i] = it_id
        types_by_id = {}
        for nct in scheduler.templates:
            for it in nct.instance_type_options:
                types_by_id[id(it)] = it

        # claims often share requirement rows and surviving-type sets:
        # decode each distinct one once
        row_cache: dict[bytes, Requirements] = {}
        live_cache: dict[bytes, list] = {}

        def decode_cached(slot: int) -> Requirements:
            key = b"".join(np.ascontiguousarray(a[slot]).tobytes() for a in creq)
            got = row_cache.get(key)
            if got is None:
                got = decode_row(vocab, creq.row(slot))
                row_cache[key] = got
            return got.copy()

        claims: list[SchedulingNodeClaim] = []
        for slot in range(n_claims):
            nct = scheduler.templates[int(tmpl[slot])]
            claim = SchedulingNodeClaim.__new__(SchedulingNodeClaim)
            claim.template = nct
            claim.hostname = nodes_mod.next_placeholder_hostname()
            claim.requirements = decode_cached(slot)
            akey = alive_bits[slot].tobytes()
            live = live_cache.get(akey)
            if live is None:
                live = [types_by_id[ordered_types[i]] for i in np.flatnonzero(alive_bits[slot])]
                live_cache[akey] = live
            claim.instance_type_options = InstanceTypes(live)
            claim.requests = table.decode(crequests[slot])
            claim.daemon_resources = scheduler.daemon_overhead[nct]
            claim.pods = []
            claim.topology = scheduler.topology
            claim.host_port_usage = scheduler.daemon_host_ports[nct].copy()
            claim.reservation_manager = scheduler.reservation_manager
            claim.reserved_offerings = []
            claim.reserved_offering_strict = False
            claim.reserved_capacity_enabled = self.opts.reserved_capacity_enabled
            claim.annotations = dict(nct.annotations)
            claims.append(claim)

        # reserved capacity: the device's per-claim held words become the
        # claims' reserved offerings and the host ReservationManager's state
        if p.num_reservations and n_claims:
            held_bits = np.unpackbits(
                np.ascontiguousarray(_np_words(st.held[:n_claims])).astype("<u4").view(np.uint8),
                axis=-1,
                bitorder="little",
            )[:, : p.num_reservations]
            from karpenter_tpu_torch.scheduling import ALLOW_UNDEFINED_WELL_KNOWN_LABELS

            for slot, claim in enumerate(claims):
                rids = {p.rid_names[r] for r in np.flatnonzero(held_bits[slot])}
                if not rids:
                    continue
                offs = [
                    o
                    for it in claim.instance_type_options
                    for o in it.offerings
                    if o.available
                    and o.capacity_type() == well_known.CAPACITY_TYPE_RESERVED
                    and o.reservation_id() in rids
                    and claim.requirements.is_compatible(o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
                ]
                claim.reserved_offerings = offs
                scheduler.reservation_manager.reserve(claim.hostname, *offs)

        for e, node in enumerate(scheduler.existing_nodes):
            node.remaining_resources = table.decode(eavail[e])
            reqs = decode_row(vocab, ereq.row(e))
            reqs.add(Requirement(well_known.HOSTNAME_LABEL_KEY, Operator.IN, [node.view.hostname]))
            node.requirements = reqs

        # nodepool-limit spend back to the host (subtractMax lives in trem)
        for t, nct in enumerate(scheduler.templates):
            if not p.thas_limits[t]:
                continue
            rem = {}
            for name, ri in table.index.items():
                if p.tlimit_def[t, ri]:
                    rem[name] = int(trem[t, ri]) * table.scale[ri]
            scheduler.remaining_resources[nct.nodepool_name] = rem

        from karpenter_tpu_torch.scheduling.hostports import get_host_ports

        pod_errors: dict[str, str] = {}
        for i, pod in enumerate(p.pods):
            kind, slot = int(kinds[i]), int(slots[i])
            if kind == K.KIND_EXISTING:
                scheduler.existing_nodes[slot].pods.append(pod)
                if p.num_host_ports:
                    hp = get_host_ports(pod)
                    if hp:
                        scheduler.existing_nodes[slot].host_port_usage.add(pod, hp)
            elif kind in (K.KIND_CLAIM, K.KIND_NEW):
                claims[slot].pods.append(pod)
                if p.num_host_ports:
                    hp = get_host_ports(pod)
                    if hp:
                        claims[slot].host_port_usage.add(pod, hp)
            elif not timed_out:
                pod_errors[pod.uid] = self._error_for(pod)

        scheduler.new_node_claims = claims

        # sync the host Topology's domain counts from the device state
        for g, vg in enumerate(p.vgroups):
            vals = vocab.values[vg.kid]
            tg = vg.group
            for vid, val in enumerate(vals):
                if p.v_reg[g, vid] or v_cnt[g, vid]:
                    tg.domains[val] = int(v_cnt[g, vid])
        # claim slots sit at offset p.num_existing (the pow2-padded count)
        hostnames = [(slot, n.view.hostname) for slot, n in enumerate(scheduler.existing_nodes)] + [
            (p.num_existing + j, c.hostname) for j, c in enumerate(claims)
        ]
        for g, hg in enumerate(p.hgroups):
            tg = hg.group
            for slot, hn in hostnames:
                c = int(h_cnt[g, slot])
                if c:
                    tg.domains[hn] = c
        return Results(
            new_node_claims=claims,
            existing_nodes=scheduler.existing_nodes,
            pod_errors=pod_errors,
            timed_out=timed_out,
        )

    def _error_for(self, pod: Pod) -> str:
        """A template-level failure message with the oracle's wording:
        limits filter, then requirements compat, then the instance-type
        filter; topology-caused failures get a generic message."""
        from karpenter_tpu_torch.scheduling import ALLOW_UNDEFINED_WELL_KNOWN_LABELS, Taints
        from karpenter_tpu_torch.solver.oracle import _filter_by_remaining_resources

        scheduler = self.oracle
        data = scheduler.cached_pod_data[pod.uid]
        errs = []
        for nct in scheduler.templates:
            its = nct.instance_type_options
            rem = scheduler.remaining_resources.get(nct.nodepool_name)
            if rem is not None:
                its = InstanceTypes(_filter_by_remaining_resources(its, rem))
                if not its:
                    errs.append(
                        f"all available instance types exceed limits for nodepool {nct.nodepool_name!r}"
                    )
                    continue
            terr = Taints(nct.taints).tolerates_pod(pod)
            if terr is not None:
                errs.append(terr)
                continue
            requirements = Requirements(nct.requirements.values())
            err = requirements.compatible(data.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
            if err is not None:
                errs.append(f"incompatible requirements, {err}")
                continue
            requirements.add(*data.requirements.values())
            total = res.merge(scheduler.daemon_overhead[nct], data.requests)
            _, _, ferr = filter_instance_types(
                its, requirements, data.requests, scheduler.daemon_overhead[nct], total
            )
            if ferr is not None:
                errs.append(str(ferr))
        if not errs:
            return "unsatisfiable topology constraint"
        return "; ".join(errs)
