"""K1 `typeok_screen`'s plain version and host side against the JAX package.

The CUDA kernel (karpenter_tpu_torch/csrc/typeok.cu) runs only on the
card, where chip_smoke.py holds it bit for bit to `typeok_plain`. On the
CPU the wrapper takes the plain version, so these tests hold:

- `typeok_plain` to the reference's `_typeok_chunk_impl` on the edges the
  kernel must keep: a type count that is not a multiple of 32 (a partial
  last word), a vocabulary at and near the kernel's 64-key limit, and
  class rows padded by repetition (each padded row's words equal its
  source row's, so a screen of the distinct rows, repeated, is the same);
- the callers screen their distinct rows only: `_pod_typeok` screens
  `_class_rows` and repeats the words as `_cr_padded` repeats the rows,
  `_tier_rows` holds the relaxable classes x tiers unpadded;
- the launch's host-side sizing: `typeok_tiling` (class rows a CTA, mask
  words a shared-memory stage) and `_typeok_smem`, the bytes the CUDA
  source lays out; and the cached type half: its flag rows, which the
  kernel copies 4 bytes at a time, start on a 4-byte boundary even from a
  view that does not, it owns every copy it points at, each type table
  keeps its own entry, and the entry goes with its types.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.api.objects import Operator
from karpenter_tpu.ops import kernels as JKN
from karpenter_tpu.ops.encode import encode_requirements
from karpenter_tpu.ops.vocab import Vocab
from karpenter_tpu.scheduling import Requirement, Requirements
from karpenter_tpu.solver.tpu import _typeok_chunk_impl
from karpenter_tpu.testing import fuzz
from karpenter_tpu_torch import device as D
from karpenter_tpu_torch import wire
from karpenter_tpu_torch.ops import kernels as TKN
from karpenter_tpu_torch.ops.encode import Reqs as TReqs
from karpenter_tpu_torch.solver import tpu as PT
from karpenter_tpu_torch.solver.topology import Topology as PTopology
from karpenter_tpu_torch.solver.tpu_problem import encode_problem as p_encode

NUMERIC = "example.com/size"


def _wide_vocab(n_keys: int) -> tuple[Vocab, dict]:
    """n_keys keys: one numeric (Gt/Lt), one spanning two words, the rest
    of one to five values."""
    keys = {NUMERIC: [str(i) for i in range(1, 21)], "example.com/wide": [f"w{i}" for i in range(40)]}
    for k in range(n_keys - len(keys)):
        keys[f"example.com/k{k:02d}"] = [f"v{j}" for j in range(1 + k % 5)]
    v = Vocab()
    for k, vals in keys.items():
        v.observe_requirement(Requirement(k, Operator.IN, vals))
    v.finalize()
    return v, keys


def _random_rows(rng: np.random.RandomState, keys: dict, n: int, density: float) -> list:
    """n requirement sets over a random `density` share of the keys: In,
    NotIn, Exists, DoesNotExist, and Gt/Lt (alone and together) on the
    numeric key."""
    out = []
    for _ in range(n):
        reqs = []
        for key, vals in keys.items():
            if rng.rand() > density:
                continue
            op = rng.randint(6)
            sub = [vals[i] for i in np.flatnonzero(rng.rand(len(vals)) < 0.5)] or [vals[0]]
            if key == NUMERIC and op >= 4:
                r = Requirements([Requirement(key, Operator.GT, [str(rng.randint(0, 12))])])
                if op == 5:
                    r.add(Requirement(key, Operator.LT, [str(rng.randint(6, 21))]))
                reqs.extend(r.values())
            elif op in (0, 4, 5):
                reqs.append(Requirement(key, Operator.IN, sub))
            elif op == 1:
                reqs.append(Requirement(key, Operator.NOT_IN, sub))
            elif op == 2:
                reqs.append(Requirement(key, Operator.EXISTS))
            else:
                reqs.append(Requirement(key, Operator.DOES_NOT_EXIST))
        out.append(Requirements(reqs))
    return out


def _both(vocab: Vocab, enc):
    jax_side = (type(enc)(*(jnp.asarray(a) for a in enc)), JKN.VocabArrays.from_vocab(vocab))
    torch_side = (TReqs(*(D.to_tensor(np.asarray(a), "cpu") for a in enc)), TKN.VocabArrays.from_vocab(vocab, "cpu"))
    return jax_side, torch_side


def _words(jax_out) -> np.ndarray:
    return np.asarray(jax_out).view(np.int32)


@pytest.mark.parametrize("n_keys", [61, 64])
def test_typeok_plain_near_the_key_limit(n_keys):
    """75 types (three words, the last partial) against 20 class rows on a
    vocabulary of 61 and of 64 keys; rows define few keys, so many pairs
    intersect."""
    vocab, keys = _wide_vocab(n_keys)
    assert vocab.num_keys == n_keys
    rng = np.random.RandomState(n_keys)
    types = encode_requirements(vocab, _random_rows(rng, keys, 75, 0.08))
    classes = encode_requirements(vocab, _random_rows(rng, keys, 20, 0.05))
    (jt, jva), (tt, tva) = _both(vocab, types)
    (jc, _), (tc, _) = _both(vocab, classes)
    want = _words(_typeok_chunk_impl(jt, jva, jc, 3))
    got = PT.typeok_plain(tt, tva, tc, 3)
    assert np.array_equal(want, got.numpy())
    bits = np.unpackbits(want.view(np.uint8), bitorder="little").reshape(20, 96)
    assert bits[:, :75].any() and not bits[:, :75].all()
    assert not bits[:, 75:].any()  # no bit past the last type


def test_typeok_plain_periodic_rows():
    """Five class rows padded to 16 by repetition (row b is row b mod 5):
    each padded row's words equal its source row's, so the screen of the
    five, repeated (what `_pod_typeok` does), is the reference's screen of
    the sixteen."""
    vocab, keys = _wide_vocab(12)
    rng = np.random.RandomState(9)
    types = encode_requirements(vocab, _random_rows(rng, keys, 45, 0.3))
    classes = encode_requirements(vocab, _random_rows(rng, keys, 5, 0.3))
    padded = type(classes)(*(a[np.arange(16) % 5] for a in classes))
    (jt, jva), (tt, tva) = _both(vocab, types)
    (jc, _), (tc, _) = _both(vocab, padded)
    want = _words(_typeok_chunk_impl(jt, jva, jc, 2))
    (_, _), (t5, _) = _both(vocab, classes)
    five = PT.typeok_screen(tt, tva, t5, 2)
    assert np.array_equal(want, five.repeat(4, 1)[:16].numpy())
    assert np.array_equal(want, PT.typeok_screen(tt, tva, tc, 2).numpy())
    assert five.ne(0).any()


def _port_problem(case: fuzz.FuzzCase):
    pools, ibp, pods, views, daemons, options, _force, source = wire._decode_problem_dict(case.problem)
    topo = PTopology(pools, ibp, pods, cluster=source, state_node_views=views, ignore_preferences=options.ignore_preferences)
    sched = PT.TorchScheduler(pools, ibp, topo, views, daemons, options, device="cpu")
    return sched, p_encode(sched.oracle, pods)


@pytest.mark.parametrize("seed", [7000, 7034, 7057])
def test_callers_pad_rows_with_the_period_they_pass(seed):
    """The callers hand the screen their distinct rows: `_class_rows` one
    a requirement class and `_tier_rows` one a relaxable class x tier; the
    class screen's words are repeated as `_cr_padded` repeats the rows
    (period n, the requirement classes), and equal the screen of the
    padded rows."""
    sched, p = _port_problem(fuzz.generate_case(seed))
    cr = sched._cr_padded(p)
    n = len(p.rclass_creps)
    assert len(cr) > n  # the bucket pads
    assert np.array_equal(cr, cr[np.arange(len(cr)) % n])
    rows = sched._class_rows(p)
    assert rows.mask.shape[0] == n
    for f, a in zip(rows, p.preq_c):
        assert np.array_equal(f.numpy(), D.to_tensor(a[cr[:n]], "cpu").numpy())
    tiers = sched._tier_rows(p)
    m = len(p.rt_tier_reqs) * p.num_tiers
    assert tiers.mask.shape[0] == m
    tb = sched._tables(p)
    assert sched._typeok.shape[0] == len(cr)
    assert torch.equal(sched._typeok, sched._typeok[torch.arange(len(cr)) % n])
    padded = TReqs(*(D.to_tensor(a[cr], "cpu") for a in p.preq_c))
    IW = sched._typeok.shape[1]
    assert torch.equal(sched._typeok, PT.typeok_plain(tb.ireq, tb.va, padded, IW))
    NRx, L = len(p.rt_tier_reqs), p.num_tiers
    assert torch.equal(tb.rt_typeok[:NRx], PT.typeok_plain(tb.ireq, tb.va, tiers, IW).reshape(NRx, L, IW))


def test_typeok_tiling_fills_the_ctas_and_the_shared_memory():
    """Rows a CTA: a warp a row, up to the CTA's 8 and at most n; mask
    words a stage: all of TW where they fit 48 KB, else the most that fit."""
    # the headline's class rows, c6's tier rows, the 2048-type catalog's
    assert PT.typeok_tiling(37, 36, 16) == (8, 36)
    assert PT.typeok_tiling(4, 36, 16) == (4, 36)
    assert PT.typeok_tiling(35, 108, 16) == (8, 108)
    assert PT.typeok_tiling(1, 17, 13) == (1, 17)
    for n, tw, k in ((37, 36, 16), (37, 108, 64), (64, 3000, 64), (1, 5000, 1), (9, 401, 61), (8, 123, 64)):
        rb, cw = PT.typeok_tiling(n, tw, k)
        assert 1 <= rb <= min(8, n) and 1 <= cw <= tw
        assert PT._typeok_smem(rb, cw, k) <= PT._TYPEOK_SMEM_MAX
        if cw < tw:  # a stage is as wide as the shared memory allows
            assert PT._typeok_smem(rb, cw + 1, k) > PT._TYPEOK_SMEM_MAX
    assert PT.typeok_tiling(64, 3000, 64)[1] < 3000  # a vocabulary this wide takes stages


def test_typeok_smem_counts_the_layout():
    """The bytes csrc/typeok.cu lays out: the types' three key masks (u64
    x 32), [cw][33] type words, [rb][cw] row words, cw word keys, [K][33]
    type bounds twice, [rb][K] row bounds twice, the types' three flag
    rows (32 K bytes each)."""
    rb, cw, k = 4, 36, 16
    want = 3 * 32 * 8 + 4 * (cw * 33 + rb * cw + cw + 2 * k * 33 + 2 * rb * k) + 3 * 32 * k
    assert PT._typeok_smem(rb, cw, k) == want


def test_type_half_aligns_the_flag_rows():
    """A type table whose flag rows are views starting off a 4-byte
    boundary gets aligned copies in the cached type half (the kernel's
    4-byte copies need it); aligned rows are used as they are, and the
    same (types, vocabulary) hits the cache."""
    vocab, keys = _wide_vocab(13)
    types = encode_requirements(vocab, _random_rows(np.random.RandomState(2), keys, 40, 0.3))
    (_, _), (tt, tva) = _both(vocab, types)
    dev = torch.device("cpu")
    # each flag row one byte into a larger buffer: contiguous, off by one
    off = tt._replace(**{
        f: torch.cat([getattr(tt, f).new_zeros(1), getattr(tt, f).reshape(-1)])[1:].view(tt.other.shape)
        for f in ("other", "notin", "defined")
    })
    assert all(getattr(off, f).data_ptr() % 4 and getattr(off, f).is_contiguous() for f in ("other", "notin", "defined"))
    half = PT._typeok_types(off, tva, dev)
    owned = {t.data_ptr(): t for t in half.owned}
    for f in ("other", "notin", "defined"):
        ptr = getattr(half.args, f)
        assert ptr % 4 == 0
        assert torch.equal(owned[ptr], getattr(off, f))
    assert PT._typeok_types(off, tva, dev) is half
    aligned = PT._typeok_types(tt, tva, dev)
    assert aligned is not half and aligned.args.other == tt.other.data_ptr()
    assert (aligned.args.I, aligned.args.TW, aligned.args.K) == (40, tt.mask.shape[1], 13)


def test_type_half_owns_its_copies_and_goes_with_its_types():
    """The type half owns the int32 word2key it points at (the vocabulary
    holds int64), and holds none of its sources; two type tables keep two
    entries (a screen of one never evicts the other's, as concurrent fleet
    lanes need), and an entry goes when its types are freed."""
    vocab, keys = _wide_vocab(9)
    rng = np.random.RandomState(4)
    (_, _), (ta, tva) = _both(vocab, encode_requirements(vocab, _random_rows(rng, keys, 20, 0.3)))
    (_, _), (tb, _) = _both(vocab, encode_requirements(vocab, _random_rows(rng, keys, 33, 0.3)))
    dev = torch.device("cpu")
    assert tva.word2key.dtype == torch.int64
    ha = PT._typeok_types(ta, tva, dev)
    (w2k,) = [t for t in ha.owned if t.data_ptr() == ha.args.word2key]
    assert w2k.dtype == torch.int32 and torch.equal(w2k, tva.word2key.to(torch.int32))
    sources = PT._typeok_sources(ta, tva)
    assert not any(o is s for o in ha.owned for s in sources)
    hb = PT._typeok_types(tb, tva, dev)
    assert hb is not ha and PT._typeok_types(ta, tva, dev) is ha
    n = len(PT._TYPE_HALVES)
    del ta, sources
    gc.collect()
    assert len(PT._TYPE_HALVES) == n - 1
    assert PT._typeok_types(tb, tva, dev) is hb
