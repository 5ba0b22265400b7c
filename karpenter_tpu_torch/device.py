"""Device choice and the bit-word policy.

Bit words. The reference carries requirement masks, type sets and port sets
as uint32 words. Torch's uint32 has no shifts, so the port carries every
such word as an int32 tensor holding the same 32 bits (`np.uint32` arrays
are viewed, never converted). `(w >> b) & 1` is exact for b in 0..31 under
the arithmetic shift, and OR/AND are bitwise either way; only sums need
care, which `pack` and `popcount` take.

Device. Entry points take an explicit `device`; `None` means the card.
There is no global device state and no silent CPU fallback: asking for
CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.ops.vocab import WORD_BITS


def resolve_device(device=None) -> torch.device:
    """`None`/"cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU. Anything torch.device accepts passes through."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "karpenter_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain versions on the CPU"
        )
    return dev


def to_tensor(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device` (a copy), uint32 words viewed as
    int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> the same bits as int32."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack(bits: torch.Tensor, nw: int) -> torch.Tensor:
    """[..., n] bool -> [..., nw] int32 words (bit i of the row lands in
    word i // 32, bit i % 32), the reference's `_pack` over any leading
    dims. Bits past n are zero."""
    n = bits.shape[-1]
    pad = nw * WORD_BITS - n
    if pad < 0:
        raise ValueError(f"{n} bits do not fit in {nw} words")
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(bits.shape[:-1] + (nw, WORD_BITS))
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=bits.device) << torch.arange(
        WORD_BITS, device=bits.device
    )
    return wrap_i32((b * weights).sum(-1))


def unpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """[..., nw] int32 words -> [..., n] bool (the reference's `_unpack`)."""
    i = torch.arange(n, device=words.device)
    sh = (i % WORD_BITS).to(torch.int32)
    return ((words[..., i // WORD_BITS] >> sh) & 1) > 0


def gather_bits(mask: torch.Tensor, words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """mask [..., TW], words/bits [G...] -> [..., G...] bool; a -1 word
    gathers False (the reference's `_gather_bits`)."""
    w = words.clamp(min=0).long()
    got = (mask[..., w] >> bits.to(torch.int32)) & 1
    return (got > 0) & (words >= 0)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (SWAR over the unsigned value), as int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = (v * 0x01010101) & 0xFFFFFFFF
    return (v >> 24).to(torch.int32)
