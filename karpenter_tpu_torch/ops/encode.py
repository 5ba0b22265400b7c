"""Requirements -> allowed-value bitmask tensors.

Encoding (per entity, per vocab key k):
- ``mask``  [TW] uint32 — allowed *vocab* values (bounds already folded in:
  a vocab value failing the requirement's own Gt/Lt bounds is cleared).
- ``other`` [K] bool — the requirement also allows values outside the vocab
  (i.e. it is a complement: NotIn / Exists / Gt / Lt).
- ``notin`` [K] bool — operator is NotIn (complement with explicit excluded
  values); needed for the NotIn/DoesNotExist tolerance rule in
  requirements.go:248 Intersects.
- ``exmask`` [TW] uint32 — for complements, the *explicitly excluded* vocab
  values that pass the requirement's own bounds. Intersections must refilter
  this set against the combined bounds (a NotIn whose excluded values all
  fail the combined Gt/Lt collapses to Exists, requirement.go:158); keeping
  it as a mask makes that an AND in the kernel and makes decode exact.
- ``defined`` [K] bool — the key is present in the requirement set. Undefined
  keys are stored as Exists (full mask + other) so intersections need no
  gating; the defined bits drive the Compatible() "custom labels must be
  defined" rule and shared-key conflict gating.
- ``gt``/``lt`` [K] int32 — integer bounds with ±sentinel defaults; combined
  bounds collapse (max(gt) >= min(lt)) kills the `other` bit exactly like
  requirement.go:158 Intersection returning DoesNotExist.
- ``minv`` [K] int32 — MinValues floor, -1 when absent.

With this layout every Requirement operation in the scheduler's hot path is a
word-wise AND plus per-key reductions — see karpenter_tpu.ops.kernels.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np

from karpenter_tpu_torch.api.objects import Operator
from karpenter_tpu_torch.ops.vocab import WORD_BITS, UnsupportedProblem, Vocab
from karpenter_tpu_torch.scheduling.requirements import (
    Requirement,
    Requirements,
    _within_bounds,
)

GT_NONE = np.int32(-(1 << 31))
LT_NONE = np.int32((1 << 31) - 1)


class Reqs(NamedTuple):
    """A batch of encoded requirement sets (a pytree of arrays; works with
    numpy for encoding and jax.numpy inside kernels)."""

    mask: np.ndarray  # [..., TW] uint32
    exmask: np.ndarray  # [..., TW] uint32
    other: np.ndarray  # [..., K] bool
    notin: np.ndarray  # [..., K] bool
    defined: np.ndarray  # [..., K] bool
    gt: np.ndarray  # [..., K] int32
    lt: np.ndarray  # [..., K] int32
    minv: np.ndarray  # [..., K] int32

    def row(self, i: int) -> "Reqs":
        return Reqs(*(a[i] for a in self))


def empty_reqs(vocab: Vocab, batch_shape: tuple[int, ...]) -> Reqs:
    """All-undefined (Exists-everything) batch."""
    tw, k = vocab.total_words, vocab.num_keys
    return Reqs(
        mask=np.broadcast_to(vocab.full_mask, batch_shape + (tw,)).copy(),
        exmask=np.zeros(batch_shape + (tw,), dtype=np.uint32),
        other=np.ones(batch_shape + (k,), dtype=bool),
        notin=np.zeros(batch_shape + (k,), dtype=bool),
        defined=np.zeros(batch_shape + (k,), dtype=bool),
        gt=np.full(batch_shape + (k,), GT_NONE, dtype=np.int32),
        lt=np.full(batch_shape + (k,), LT_NONE, dtype=np.int32),
        minv=np.full(batch_shape + (k,), -1, dtype=np.int32),
    )


def _encode_one(vocab: Vocab, out: Reqs, b: int, r: Requirement) -> None:
    kid = vocab.key_index.get(r.key)
    if kid is None:
        raise UnsupportedProblem(f"requirement key {r.key!r} not in vocab")
    off, words = vocab.word_offset[kid], vocab.words_per_key[kid]
    vals = vocab.values[kid]
    seg = np.zeros(words, dtype=np.uint32)
    exseg = np.zeros(words, dtype=np.uint32)

    def set_vid(target: np.ndarray, vid: int) -> None:
        target[vid // WORD_BITS] |= np.uint32(1 << (vid % WORD_BITS))

    if r.complement:
        # NotIn combined with Gt/Lt on the same key: the mask encoding drops
        # bound-failing excluded values, but the reference's minValues
        # distinct-value union keeps them (requirement.go Values()) — gate
        # rather than diverge
        if r.values and (r.greater_than is not None or r.less_than is not None):
            raise UnsupportedProblem(
                f"NotIn with Gt/Lt bounds on key {r.key!r} (minValues "
                "distinct-count would diverge from the reference)"
            )
        # NotIn excluded values must be in the vocab or the notin bit (and
        # with it the NotIn/DoesNotExist tolerance rule) silently flips
        for v in r.values:
            if v not in vocab.value_index[kid]:
                raise UnsupportedProblem(
                    f"excluded value {v!r} for key {r.key!r} not in vocab "
                    "(observe all requirement values before finalizing)"
                )
        # allowed = vocab \ excluded, bounds folded per value
        for vid, v in enumerate(vals):
            if not _within_bounds(v, r.greater_than, r.less_than):
                continue
            set_vid(exseg if v in r.values else seg, vid)
        # encode-time bound collapse (requirement.go:147)
        collapsed = (
            r.greater_than is not None
            and r.less_than is not None
            and r.greater_than >= r.less_than
        )
        out.other[b, kid] = not collapsed
        out.notin[b, kid] = bool(exseg.any()) and not collapsed
        if collapsed:
            seg[:] = 0
            exseg[:] = 0
        else:
            out.gt[b, kid] = GT_NONE if r.greater_than is None else r.greater_than
            out.lt[b, kid] = LT_NONE if r.less_than is None else r.less_than
    else:
        for v in r.values:
            vid = vocab.value_index[kid].get(v)
            if vid is None:
                raise UnsupportedProblem(
                    f"value {v!r} for key {r.key!r} not in vocab (observe all "
                    "requirement values before finalizing)"
                )
            set_vid(seg, vid)
        out.other[b, kid] = False
        out.notin[b, kid] = False
    out.mask[b, off : off + words] = seg
    out.exmask[b, off : off + words] = exseg
    out.defined[b, kid] = True
    out.minv[b, kid] = -1 if r.min_values is None else r.min_values


def encode_requirements(
    vocab: Vocab, batch: Iterable[Requirements], skip_keys: frozenset[str] = frozenset()
) -> Reqs:
    """Encode a list of Requirements sets into a Reqs batch. Keys in
    vocab.excluded_keys (hostname) and `skip_keys` are silently skipped —
    the solver handles them structurally."""
    batch = list(batch)
    out = empty_reqs(vocab, (len(batch),))
    skips = vocab.excluded_keys | skip_keys
    for b, reqs in enumerate(batch):
        for r in reqs.values():
            if r.key in skips:
                continue
            _encode_one(vocab, out, b, r)
    return out


def decode_row(vocab: Vocab, reqs: Reqs) -> Requirements:
    """Decode one encoded row back to Requirements.

    Exact for concrete (In / DoesNotExist) keys. Complement keys decode to
    NotIn over the exmask excluded set (vocab-relative) plus any Gt/Lt
    bounds — values never observed in this Solve are unrepresentable, which
    is semantically equivalent within the problem universe (every entity's
    values are in the vocab).
    """
    out = Requirements()
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    for kid, key in enumerate(vocab.keys):
        if not reqs.defined[kid]:
            continue
        off, words = vocab.word_offset[kid], vocab.words_per_key[kid]
        vals = vocab.values[kid]

        def set_values(flat: np.ndarray) -> list:
            # value vid is bit vid % WORD_BITS of word off + vid // WORD_BITS
            bits = (flat[off:off + words, None] >> shifts) & np.uint32(1)
            return [vals[vid] for vid in np.flatnonzero(bits.ravel()[:len(vals)])]

        minv = None if reqs.minv[kid] < 0 else int(reqs.minv[kid])
        if reqs.other[kid]:
            excluded = set(set_values(reqs.exmask))
            r = Requirement._raw(
                key,
                True,
                excluded,
                None if reqs.gt[kid] == GT_NONE else int(reqs.gt[kid]),
                None if reqs.lt[kid] == LT_NONE else int(reqs.lt[kid]),
                minv,
            )
        else:
            allowed = set_values(reqs.mask)
            r = Requirement(key, Operator.IN, allowed, minv)
        out.add(r)
    return out
