"""The requirement algebra over the Reqs bitmask encoding, on torch tensors.

A plain-torch port of the reference's `ops/kernels.py`. Each function
reproduces the Requirement algebra exactly (see ops/encode.py for the
encoding) and takes broadcastable leading dims:

- ``intersect_nonempty``   == Requirement.HasIntersection per key.
- ``compat``               == Requirements.Compatible: the defined-key rule
  plus Intersects with the NotIn/DoesNotExist tolerance.
- ``intersects_only``      == Requirements.Intersects without the
  defined-key rule (instance-type filtering).
- ``intersect``            == Requirements.Add auto-intersection.
- ``distinct_value_counts`` powers SatisfiesMinValues.

Per-key reductions are exact integer segment sums over `word2key` (the
reference used f32 one-hot matmuls as counts). Bit words are int32 tensors
(device.py). The CUDA kernels in csrc/ carry the same algebra as
`__device__` functions over 64-bit key masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from karpenter_tpu_torch.device import WORD_BITS, pack, popcount, to_tensor, unpack
from karpenter_tpu_torch.ops.encode import Reqs
from karpenter_tpu_torch.ops.vocab import Vocab


class VocabArrays(NamedTuple):
    """Static vocab tensors on one device."""

    word2key: torch.Tensor  # [TW] int64 — key id of each word
    well_known: torch.Tensor  # [K] bool
    full_mask: torch.Tensor  # [TW] int32 words

    @classmethod
    def from_arrays(cls, word2key, well_known, full_mask, device) -> "VocabArrays":
        return cls(
            word2key=torch.tensor(np.asarray(word2key), dtype=torch.int64, device=device),
            well_known=torch.tensor(np.asarray(well_known), dtype=torch.bool, device=device),
            full_mask=to_tensor(full_mask, device),
        )

    @classmethod
    def from_vocab(cls, vocab: Vocab, device) -> "VocabArrays":
        return cls.from_arrays(
            vocab.word2key, vocab.well_known_mask, vocab.full_mask, device
        )

    @property
    def num_keys(self) -> int:
        return int(self.well_known.shape[0])


def _seg_sum(vals: torch.Tensor, va: VocabArrays) -> torch.Tensor:
    """[..., TW] int32 -> [..., K] int32: exact per-key sums."""
    out = torch.zeros(
        vals.shape[:-1] + (va.num_keys,), dtype=torch.int32, device=vals.device
    )
    return out.index_add_(vals.dim() - 1, va.word2key, vals.to(torch.int32))


def seg_any(word_flags: torch.Tensor, va: VocabArrays) -> torch.Tensor:
    """[..., TW] bool -> [..., K] bool: any set word per key."""
    return _seg_sum(word_flags, va) > 0


def seg_popcount(mask: torch.Tensor, va: VocabArrays) -> torch.Tensor:
    """[..., TW] int32 words -> [..., K] int32: set-bit count per key."""
    return _seg_sum(popcount(mask), va)


def _dne(r: Reqs, va: VocabArrays) -> torch.Tensor:
    """[..., K] operator()==DoesNotExist: concrete with empty allowed set."""
    return ~r.other & ~seg_any(r.mask != 0, va)


def intersect_nonempty(a: Reqs, b: Reqs, va: VocabArrays) -> torch.Tensor:
    """[..., K] bool — the per-key HasIntersection."""
    seg = seg_any((a.mask & b.mask) != 0, va)
    gt = torch.maximum(a.gt, b.gt)
    lt = torch.minimum(a.lt, b.lt)
    other = a.other & b.other & (gt < lt)
    return seg | other


def _conflict(a: Reqs, b: Reqs, va: VocabArrays) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-key conflict of shared defined keys, minus the NotIn/DoesNotExist
    tolerance. Returns (conflict[..., K], b_tol)."""
    nonempty = intersect_nonempty(a, b, va)
    a_tol = a.notin | _dne(a, va)
    b_tol = b.notin | _dne(b, va)
    conflict = a.defined & b.defined & ~nonempty & ~(a_tol & b_tol)
    return conflict, b_tol


def compat(a: Reqs, b: Reqs, va: VocabArrays, allow_undefined_well_known: bool) -> torch.Tensor:
    """[...] bool — Requirements.Compatible(a=target/node, b=incoming/pod)."""
    conflict, b_tol = _conflict(a, b, va)
    def_fail = b.defined & ~a.defined & ~b_tol
    if allow_undefined_well_known:
        def_fail = def_fail & ~va.well_known
    return ~torch.any(conflict | def_fail, dim=-1)


def intersects_only(a: Reqs, b: Reqs, va: VocabArrays) -> torch.Tensor:
    """[...] bool — Requirements.Intersects without the defined-key rule."""
    conflict, _ = _conflict(a, b, va)
    return ~torch.any(conflict, dim=-1)


def intersect(a: Reqs, b: Reqs, va: VocabArrays) -> Reqs:
    """Key-wise intersection of two requirement sets (Requirements.Add);
    a complement∧complement result refilters its excluded set against the
    combined bounds, so a NotIn whose excluded values all fail them
    collapses to Exists."""
    gt = torch.maximum(a.gt, b.gt)
    lt = torch.minimum(a.lt, b.lt)
    collapse = gt >= lt
    other = a.other & b.other & ~collapse
    keep = ~collapse[..., va.word2key]
    zero = torch.zeros((), dtype=torch.int32, device=a.mask.device)
    mask = torch.where(keep, a.mask & b.mask, zero)
    exmask = (a.exmask & (b.mask | b.exmask)) | (b.exmask & (a.mask | a.exmask))
    exmask = torch.where(keep & other[..., va.word2key], exmask, zero)
    return Reqs(
        mask=mask,
        exmask=exmask,
        other=other,
        notin=other & seg_any(exmask != 0, va),
        defined=a.defined | b.defined,
        gt=gt,
        lt=lt,
        minv=torch.maximum(a.minv, b.minv),
    )


def distinct_value_counts(masks: torch.Tensor, alive: torch.Tensor, va: VocabArrays) -> torch.Tensor:
    """[K] int32 — distinct allowed values per key across alive rows.

    masks: [I, TW] int32 words, alive: [I] bool. Callers pre-select the
    per-key source (concrete -> mask, complement -> exmask, undefined ->
    zero), as the solver's `_min_values_ok` does."""
    zero = torch.zeros((), dtype=torch.int32, device=masks.device)
    masked = torch.where(alive[:, None], masks, zero)
    return seg_popcount(bitwise_or_reduce(masked, 0), va)


def bitwise_or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """OR of [..., nw] int32 words along `dim` (not the word dim), exact:
    per-bit any, repacked."""
    nw = x.shape[-1]
    return pack(unpack(x, nw * WORD_BITS).any(dim=dim), nw)
