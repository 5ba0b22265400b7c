"""Pow-2 shape buckets: every axis the jitted entry points see is padded
to a small ladder OUTSIDE jit, so steady-state traffic reuses a handful of
compiled programs instead of recompiling per problem size.

SURVEY.md §7 names the wall ("counts vary per Solve -> recompilation
pressure. Plan: bucketed padding to fixed shapes (pow-2 pods/types/keys),
interning layer outside jit"); BENCH_r03-r05 measured it at 25-57s of
one-time compile. The ladder bounds the number of distinct compiled
shapes per axis to log2(range), which is what makes ahead-of-time
compilation (solver/aot.py) and the persistent cache
(jaxsetup.ensure_compilation_cache) a finite, enumerable artifact.

Bucketed axes and their sentinel-invisibility arguments:

- pods P: per-round index arrays pad to pow2 (TpuScheduler._pod_xs_with_idx);
  padding positions carry idx 0 and `valid=False`, the kernel never visits
  them. The per-pod class/selection columns uploaded once per solve pad
  here (`pad_rows`) — padded entries are only ever gathered by padding
  positions.
- claim slots N: pow2 since round 3 (adaptive growth doubles the bucket);
  inert slots are `active=False` rows the per-step screens skip.
- existing-node slots E: pow2 since round 5 (tpu_problem E_pad); padded
  slots carry eavail=-1 (fails every fits check) and all-False toleration
  columns.
- instance types I (`pad_types`): padded type rows are members of NO
  template (`ttypes` bits stay 0), so `tmember`/`talive` exclude them from
  every exact filter and they can never enter a claim's surviving-type
  set; ialloc/icap are zero and ireq rows empty, but both sit behind the
  membership gate.
- offerings O (`pad_offerings`): padded rows carry `ovalid=False`, which
  the kernel ANDs into the offering screen (tpu_kernel._type_filter and
  the reservation candidate mask) — a padded offering can never witness
  "an offering exists" nor hold a reservation. Host-side gates iterate
  `num_offerings_real` rows only.
- vocab words/keys: Vocab.finalize(pad_words=..., pad_keys=...) pads each
  key's word count and the key count. Phantom word bits are exactly the
  tail bits a non-multiple-of-32 value count already leaves in its last
  word: never set in full_mask, never set by any encoded row, invisible
  to every seg reduction. Phantom keys are named under a reserved prefix,
  carry one zero word and no values; every row leaves them
  defined=False, which gates all of compat/intersect semantics.
- requirement classes NR / encode classes NC / selection rows U
  (`pad_rows`, applied in TpuScheduler._upload_pod_tables): the gather
  indices (cls/srow/rcls_of columns) only ever contain real ids, so pad
  rows are dead weight shipped for shape stability.

The parity proof is tests/test_buckets.py: problems straddling each
bucket edge stay bit-identical to the oracle, and two different real
sizes in one bucket hit the identical compiled program (0 traces on the
second solve).

Opt out with KARPENTER_SHAPE_BUCKETS=0 (exact shapes, the pre-bucketing
behavior — kept for A/B debugging, not for production).
"""

from __future__ import annotations

import os

import numpy as np

# reserved prefix for phantom vocab keys — ops/vocab.py owns it (ops/
# cannot import solver/); re-exported here for bucket-layer consumers
from karpenter_tpu_torch.ops.vocab import PAD_KEY_PREFIX


def enabled() -> bool:
    """Shape bucketing is ON by default; KARPENTER_SHAPE_BUCKETS=0/off
    restores exact shapes."""
    raw = os.environ.get("KARPENTER_SHAPE_BUCKETS", "1").strip().lower()
    return raw not in ("0", "off", "false", "")


def bucket(n: int, floor: int = 8) -> int:
    """Smallest pow2 >= n, floored (the ladder rung for a count)."""
    out = floor
    while out < n:
        out *= 2
    return out


def bucket_words(n: int) -> int:
    """Per-key word-count rung (floor 1: most keys hold <32 values)."""
    return bucket(n, floor=1)


def bucket_keys(n: int) -> int:
    """Vocab key-count rung."""
    return bucket(n, floor=8)


def bucket_lanes(n: int) -> int:
    """Fleet-lane rung (solver/fleet.py): the pow-2 lane count a
    coalesced batch window pads to (floor 2 — a single lane never
    dispatches the vmapped entry; it falls back to the solo path)."""
    return bucket(n, floor=2)


def ladder(lo: int, hi: int, floor: int = 8) -> list[int]:
    """Every rung from bucket(lo) up to bucket(hi) inclusive."""
    out = []
    r = bucket(max(1, lo), floor=floor)
    top = bucket(max(1, hi), floor=floor)
    while r <= top:
        out.append(r)
        r *= 2
    return out


def pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of `a` up to n rows with `fill` (no-op when already
    there). Used for the per-class upload tables — pad rows are never
    gathered (indices only reference real rows)."""
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad])


def pad_types(p) -> None:
    """Pad the instance-type axis I to its rung. Padded types belong to no
    template (ttypes bits stay zero), so every exact filter excludes them;
    their ireq rows are empty (all-undefined) and ialloc/icap zero."""
    from karpenter_tpu_torch.ops.encode import Reqs, empty_reqs

    I = p.num_types
    I_pad = bucket(I)
    if I_pad <= I:
        return
    R = p.ialloc.shape[1]
    pad_req = empty_reqs(p.vocab, (I_pad - I,))
    p.ireq = Reqs(*(np.concatenate([a, b]) for a, b in zip(p.ireq, pad_req)))
    p.ialloc = np.concatenate(
        [p.ialloc, np.zeros((I_pad - I, R), np.int32)]
    )
    p.icap = np.concatenate([p.icap, np.zeros((I_pad - I, R), np.int32)])
    p.num_types = I_pad
    # membership words grow with IW = ceil(I/32); bits for padded types
    # stay zero in every template row
    from karpenter_tpu_torch.ops.vocab import WORD_BITS

    IW = max(1, (I_pad + WORD_BITS - 1) // WORD_BITS)
    if p.ttypes.shape[1] < IW:
        p.ttypes = np.concatenate(
            [
                p.ttypes,
                np.zeros((p.ttypes.shape[0], IW - p.ttypes.shape[1]), np.uint32),
            ],
            axis=1,
        )


def pad_offerings(p) -> None:
    """Pad the offering axis O to its rung. Padded rows are screened out
    by ovalid=False in the kernel; host gates iterate only the
    `num_offerings_real` prefix."""
    O = p.otype.shape[0]
    p.num_offerings_real = O
    p.ovalid = np.ones(O, dtype=bool)
    O_pad = bucket(O)
    if O_pad <= O:
        return
    extra = O_pad - O
    p.otype = np.concatenate([p.otype, np.zeros(extra, np.int32)])
    p.oword = np.concatenate([p.oword, np.full((extra, 3), -1, np.int32)])
    p.obit = np.concatenate([p.obit, np.zeros((extra, 3), np.int32)])
    p.orid = np.concatenate([p.orid, np.full(extra, -1, np.int32)])
    p.ovalid = np.concatenate([p.ovalid, np.zeros(extra, dtype=bool)])


def pad_problem(p) -> None:
    """Apply the post-encode pads (types, offerings) to an EncodedProblem.
    Existing-node and vocab padding happen inside encode_problem/finalize
    because downstream tables are sized off them."""
    if not enabled():
        p.num_offerings_real = p.otype.shape[0]
        p.ovalid = np.ones(p.otype.shape[0], dtype=bool)
        return
    pad_types(p)
    pad_offerings(p)


def signature(p) -> tuple:
    """The bucketed shape signature of an encoded problem — the key the
    AOT manifest records per compiled combo (solver/aot.py). Two problems
    with equal signatures compile to byte-identical programs for the
    per-solve entry points."""
    vocab, table = p.vocab, p.table
    return (
        ("E", p.num_existing),
        ("I", p.num_types),
        ("O", int(p.otype.shape[0])),
        ("R", table.num_resources),
        ("T", p.num_templates),
        ("TW", vocab.total_words),
        ("K", vocab.num_keys),
        ("Gv", len(p.vgroups)),
        ("Gh", len(p.hgroups)),
        ("VMAX", p.vmax),
        ("L", p.num_tiers),
        ("HP", (p.num_host_ports + 31) // 32),
        ("NRES", p.num_reservations),
    )
