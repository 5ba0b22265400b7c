"""The step kernels' type tables (`tpu_kernel.type_tables`) against the JAX
package's requirement algebra.

The CUDA step kernels (K2, K3, K7 and the sweeps' cache) stage these
tables in shared memory once per launch and run the type filter on them
alone: the types' mask words word-major, the bounds of the keys some type
bounds (every other key's bounds come from the working row, the type's
being the sentinels), the allocatable resource-major and the offerings
grouped by their three word/bit probes, beside each type's key masks,
which the kernels' prologue derives with algebra.cuh `row_keys`. Here the
tables of numpy-seeded requirement batches (bounds, collapses, NotIn and
DoesNotExist rows) are derived on the CPU and the kernel's formulas,
written out below, are held to `ops/kernels.py`: the key masks to
`seg_any`/`_dne`, the per-key conflict to `_conflict`, and the offering
classes' fold to a direct evaluation of every offering. The wrapper
derives the tables once per Tables (`launch_type_tables`).
"""

import gc


from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import kernels as JKN
from karpenter_tpu.ops.encode import encode_requirements
from karpenter_tpu_torch import device as D
from karpenter_tpu_torch.ops import kernels as TKN
from karpenter_tpu_torch.ops.encode import Reqs as TReqs
from karpenter_tpu_torch.solver import tpu_kernel as TK
from tests.test_torch_algebra import NUMERIC, _random_requirements, _vocab

M64 = (1 << 64) - 1


def _tables(seed: int, n_types: int = 40, n_offers: int = 300, R: int = 3):
    """A vocabulary, the types' encoded rows (numpy) and a Tables stand-in
    with the fields type_tables reads."""
    vocab = _vocab()
    rng = np.random.RandomState(seed)
    enc = encode_requirements(vocab, [_random_requirements(rng) for _ in range(n_types)])
    TW = enc.mask.shape[1]
    word = rng.randint(-1, TW, size=(n_offers, 3)).astype(np.int32)
    bit = rng.randint(0, 32, size=(n_offers, 3)).astype(np.int32)
    bit[rng.rand(n_offers, 3) < 0.05] = 40  # a probe no word bit can pass
    otype = rng.randint(-2, n_types + 2, size=n_offers).astype(np.int32)
    tb = SimpleNamespace(
        va=TKN.VocabArrays.from_vocab(vocab, "cpu"),
        ireq=TReqs(*(D.to_tensor(np.asarray(a), "cpu") for a in enc)),
        ialloc=torch.from_numpy(rng.randint(0, 1000, size=(n_types, R)).astype(np.int32)),
        otype=torch.from_numpy(otype),
        oword=torch.from_numpy(word),
        obit=torch.from_numpy(bit),
        ovalid=torch.from_numpy(rng.rand(n_offers) < 0.8),
        ttypes=torch.zeros((1, (n_types + 31) // 32), dtype=torch.int32),
    )
    return vocab, enc, tb


def _u64(x) -> int:
    return int(x) & M64


def _bits(flags) -> int:
    return sum(1 << k for k, f in enumerate(flags) if f)


def _row_keys(enc, b: int, w2k, K: int):
    """(other, defined, tol) of row b as the kernels keep them: 64-bit
    masks, tol with every bit past K set (algebra.cuh row_keys)."""
    seg = 0
    for w, m in enumerate(enc.mask[b]):
        if m != 0:
            seg |= 1 << int(w2k[w])
    other, notin = _bits(enc.other[b]), _bits(enc.notin[b])
    return other, _bits(enc.defined[b]), (notin | (~other & ~seg)) & M64


def _kernel_conflict(tt, ikeys, w2k, K: int, rkeys, rmask, rgt, rlt, i: int) -> int:
    """step.cuh type_compatible's conflict of type i against a working row,
    from the type tables and type i's key masks `ikeys` alone."""
    io, idf, it = ikeys
    ro, rd, rt = rkeys
    low = (1 << K) - 1
    cand = idf & rd & ~(it & rt) & low
    seg = 0
    for w in range(len(w2k)):
        key = int(w2k[w])
        if (cand >> key) & 1 and (int(tt.imask_t[w, i]) & int(rmask[w])) != 0:
            seg |= 1 << key
    bk = [int(k) for k in tt.bkeys]
    bnd = 0
    for k in range(K):
        if k in bk:
            j = bk.index(k)
            gt, lt = max(int(tt.igt_t[j, i]), int(rgt[k])), min(int(tt.ilt_t[j, i]), int(rlt[k]))
        else:
            gt, lt = int(rgt[k]), int(rlt[k])
        if gt < lt:
            bnd |= 1 << k
    return cand & ~(seg | (io & ro & bnd)) & M64


def test_launch_type_tables_derived_once_per_tables():
    _, _, tb = _tables(5)
    tt = TK.launch_type_tables(tb)
    assert TK.launch_type_tables(tb) is tt  # a second launch on the same Tables
    want = TK.type_tables(tb)
    for name in TK.TypeTables._fields:
        assert torch.equal(getattr(tt, name), getattr(want, name)), name
    # other tensors, even with equal values, are other Tables
    tb2 = SimpleNamespace(**vars(tb))
    tb2.ialloc = tb.ialloc.clone()
    tb2.ialloc[0, 0] += 1
    tt2 = TK.launch_type_tables(tb2)
    assert tt2 is not tt and tt2.ialloc_t[0, 0] == tt.ialloc_t[0, 0] + 1
    # no derived table keeps its Tables alive: the entries go with them
    keys = [tuple(map(id, TK._type_sources(t))) for t in (tb, tb2)]
    assert all(k in TK._TYPE_TABLES for k in keys)
    del tb, tb2, tt, tt2, want
    gc.collect()
    assert not any(k in TK._TYPE_TABLES for k in keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_type_keys_and_conflicts_match_reference(seed):
    vocab, enc, tb = _tables(seed)
    tt = TK.type_tables(tb)
    K, I = vocab.num_keys, enc.mask.shape[0]
    w2k = np.asarray(vocab.word2key)
    jva = JKN.VocabArrays.from_vocab(vocab)
    jt = type(enc)(*(jnp.asarray(a) for a in enc))
    # the key masks: other, defined, and tol = notin | _dne (seg_any)
    dne = np.asarray(JKN._dne(jt, jva))
    seg = np.asarray(JKN.seg_any(jnp.asarray(enc.mask) != 0, jva))
    assert np.array_equal(dne, ~enc.other & ~seg)
    ikeys = [_row_keys(enc, i, w2k, K) for i in range(I)]
    for i in range(I):
        o, d, t = ikeys[i]
        assert o == _bits(enc.other[i]) and d == _bits(enc.defined[i])
        assert t & ((1 << K) - 1) == _bits(enc.notin[i] | dne[i])
        assert t >> K == (1 << (64 - K)) - 1  # ~other & ~seg sets every bit past K
    # the layout the kernels read
    assert torch.equal(tt.imask_t, tb.ireq.mask.t()) and torch.equal(tt.ialloc_t, tb.ialloc.t())
    kid = vocab.key_index[NUMERIC]
    assert [int(k) for k in tt.bkeys] == [kid]  # only the numeric key carries bounds
    assert torch.equal(tt.igt_t[0], tb.ireq.gt[:, kid]) and torch.equal(tt.ilt_t[0], tb.ireq.lt[:, kid])
    # the per-key conflict of every type against rows standing in for
    # working rows (another batch), against _conflict(type, row)
    rows = encode_requirements(vocab, [_random_requirements(np.random.RandomState(100 + seed)) for _ in range(12)])
    for b in range(rows.mask.shape[0]):
        rb = type(rows)(*(jnp.asarray(a[b : b + 1]) for a in rows))
        want, _ = JKN._conflict(jt, rb, jva)
        want = np.asarray(want)
        rkeys = _row_keys(rows, b, w2k, K)
        for i in range(I):
            got = _kernel_conflict(tt, ikeys[i], w2k, K, rkeys, rows.mask[b], rows.gt[b], rows.lt[b], i)
            assert got == _bits(want[i]), (b, i)


@pytest.mark.parametrize("seed", [3, 4])
def test_offering_classes_fold_like_every_offering(seed):
    vocab, enc, tb = _tables(seed)
    tt = TK.type_tables(tb)
    I, TW = enc.mask.shape
    rng = np.random.RandomState(seed)
    word, bit = tb.oword.numpy(), tb.obit.numpy()
    otype, ovalid = tb.otype.numpy(), tb.ovalid.numpy()
    for _ in range(8):
        fmask = rng.randint(0, 2**32, size=TW, dtype=np.uint64)
        fmask[rng.rand(TW) < 0.3] = 0
        # the reference fold: a valid offering of one of the I types whose
        # every probe is off or a set bit of the row
        want = set()
        for o in range(len(otype)):
            if not ovalid[o] or not 0 <= otype[o] < I:
                continue
            ok = all(
                word[o, j] < 0 or (0 <= bit[o, j] < 32 and (int(fmask[word[o, j]]) >> int(bit[o, j])) & 1)
                for j in range(3)
            )
            if ok:
                want.add(int(otype[o]))
        # the kernel's fold over the offering classes
        got = set()
        for (p01, p2), words in zip(tt.oclass.tolist(), tt.otypes.tolist()):
            p01 &= 0xFFFFFFFF
            probes = (p01 & 0xFFFF, p01 >> 16, p2)
            if all(c == 0xFFFF or (int(fmask[c >> 5]) >> (c & 31)) & 1 for c in probes):
                got |= {w * 32 + b for w, ww in enumerate(words) for b in range(32) if (ww >> b) & 1}
        assert got == want
    # one class per distinct probe triple of the offerings that can match
    kept = ovalid & (otype >= 0) & (otype < I) & ((word < 0) | ((bit >= 0) & (bit < 32))).all(1)
    code = np.where(word < 0, 0xFFFF, word * 32 + bit)[kept]
    assert tt.oclass.shape == (len({tuple(r) for r in code.tolist()}), 2)
    assert tt.otypes.shape == (tt.oclass.shape[0], tb.ttypes.shape[1])
