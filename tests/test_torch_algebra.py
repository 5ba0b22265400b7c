"""The port's requirement algebra and type screen against the JAX package.

Random requirement batches (numpy-seeded) are encoded once by the
reference encoder and fed to both `karpenter_tpu.ops.kernels` and
`karpenter_tpu_torch.ops.kernels`; every output must be bit-identical. The
batches cover In/NotIn/Exists/DoesNotExist rows, Gt/Lt bounds (alone, both,
and collapsed), undefined keys and full-vocab complements.
"""

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
from karpenter_tpu_torch import device as D
from karpenter_tpu_torch.ops import kernels as TKN
from karpenter_tpu_torch.ops.encode import Reqs as TReqs
from karpenter_tpu_torch.solver.tpu import typeok_plain

# key -> vocab values; the size key is numeric for Gt/Lt, the type key
# spans two words
KEYS = {
    "topology.kubernetes.io/zone": [f"zone-{i}" for i in range(4)],
    "node.kubernetes.io/instance-type": [f"type-{i}" for i in range(40)],
    "example.com/size": [str(i) for i in range(1, 21)],
    "example.com/team": ["a", "b", "c"],
    "kubernetes.io/arch": ["amd64", "arm64"],
}
NUMERIC = "example.com/size"


def _vocab() -> Vocab:
    v = Vocab()
    for k, vals in KEYS.items():
        v.observe_requirement(Requirement(k, Operator.IN, vals))
    v.finalize()
    return v


def _random_requirements(rng: np.random.RandomState) -> Requirements:
    reqs = []
    for key, vals in KEYS.items():
        op = rng.randint(8)
        sub = [vals[i] for i in np.flatnonzero(rng.rand(len(vals)) < 0.4)]
        if op == 0:
            continue  # undefined
        if op == 1:
            reqs.append(Requirement(key, Operator.IN, sub))
        elif op == 2 and sub:
            reqs.append(Requirement(key, Operator.NOT_IN, sub))
        elif op == 3:
            reqs.append(Requirement(key, Operator.EXISTS))
        elif op == 4:
            reqs.append(Requirement(key, Operator.DOES_NOT_EXIST))
        elif key == NUMERIC and op == 5:
            reqs.append(Requirement(key, Operator.GT, [str(rng.randint(0, 21))]))
        elif key == NUMERIC and op == 6:
            reqs.append(Requirement(key, Operator.LT, [str(rng.randint(0, 21))]))
        elif key == NUMERIC and op == 7:
            # both bounds on one key; collapses when gt >= lt
            r = Requirements([Requirement(key, Operator.GT, [str(rng.randint(0, 21))])])
            r.add(Requirement(key, Operator.LT, [str(rng.randint(0, 21))]))
            reqs.extend(r.values())
        else:
            reqs.append(Requirement(key, Operator.IN, vals))  # the full vocab
        if rng.rand() < 0.2 and reqs and not reqs[-1].complement:
            reqs[-1].min_values = int(rng.randint(1, 4))
    return Requirements(reqs)


def _batch(seed: int, n: int):
    vocab = _vocab()
    rng = np.random.RandomState(seed)
    return vocab, encode_requirements(vocab, [_random_requirements(rng) for _ in range(n)])


def _jax(r):
    return type(r)(*(jnp.asarray(a) for a in r))


def _torch(r):
    return TReqs(*(D.to_tensor(np.asarray(a), "cpu") for a in r))


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return np.array_equal(a, torch_out.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_algebra_bit_identical(seed):
    vocab, enc = _batch(seed, 24)
    jva = JKN.VocabArrays.from_vocab(vocab)
    tva = TKN.VocabArrays.from_vocab(vocab, "cpu")
    ja = _jax(type(enc)(*(a[:, None] for a in enc)))
    jb = _jax(type(enc)(*(a[None, :] for a in enc)))
    ta = _torch(type(enc)(*(a[:, None] for a in enc)))
    tb = _torch(type(enc)(*(a[None, :] for a in enc)))

    assert _same(JKN.intersect_nonempty(ja, jb, jva), TKN.intersect_nonempty(ta, tb, tva))
    for allow in (False, True):
        assert _same(JKN.compat(ja, jb, jva, allow), TKN.compat(ta, tb, tva, allow))
    assert _same(JKN.intersects_only(ja, jb, jva), TKN.intersects_only(ta, tb, tva))
    for f, x, y in zip(enc._fields, JKN.intersect(ja, jb, jva), TKN.intersect(ta, tb, tva)):
        assert _same(x, y), f
    jm, tm = jnp.asarray(enc.mask), D.to_tensor(enc.mask, "cpu")
    assert _same(JKN.seg_any(jm != 0, jva), TKN.seg_any(tm != 0, tva))
    assert _same(JKN.seg_popcount(jm, jva), TKN.seg_popcount(tm, tva))
    assert _same(JKN._dne(_jax(enc), jva), TKN._dne(_torch(enc), tva))
    alive = np.random.RandomState(seed).rand(enc.mask.shape[0]) < 0.5
    assert _same(
        JKN.distinct_value_counts(jm, jnp.asarray(alive), jva),
        TKN.distinct_value_counts(tm, torch.from_numpy(alive), tva),
    )


def test_batches_cover_the_operator_families():
    """The generator really produces bounds, collapses, NotIn and
    DoesNotExist rows and full-vocab sets (else the parity above is thin)."""
    vocab, enc = _batch(0, 200)
    kid = vocab.key_index[NUMERIC]
    gt_set = enc.gt[:, kid] != np.iinfo(np.int32).min
    lt_set = enc.lt[:, kid] != np.iinfo(np.int32).max
    assert gt_set.any() and lt_set.any() and (gt_set & lt_set).any()
    assert (enc.defined & ~enc.other & ~enc.notin).any()  # concrete rows
    assert enc.notin.any()
    dne = enc.defined & ~enc.other
    for k in range(vocab.num_keys):
        off, w = vocab.word_offset[k], vocab.words_per_key[k]
        dne[:, k] &= ~enc.mask[:, off : off + w].any(axis=1)
    assert dne.any()
    tkid = vocab.key_index["node.kubernetes.io/instance-type"]
    off, w = vocab.word_offset[tkid], vocab.words_per_key[tkid]
    concrete = enc.defined[:, tkid] & ~enc.other[:, tkid]
    full = vocab.full_mask[off : off + w]
    assert any(np.array_equal(row, full) for row in enc.mask[concrete, off : off + w])


@pytest.mark.parametrize("seed", [3, 4])
def test_typeok_plain_matches_reference(seed):
    vocab, enc = _batch(seed, 70)
    types, classes = type(enc)(*(a[:40] for a in enc)), type(enc)(*(a[40:] for a in enc))
    iw = 2  # 40 types in two words; bits past 40 stay zero
    want = _typeok_chunk_impl(_jax(types), JKN.VocabArrays.from_vocab(vocab), _jax(classes), iw)
    got = typeok_plain(_torch(types), TKN.VocabArrays.from_vocab(vocab, "cpu"), _torch(classes), iw)
    assert _same(want, got)
    assert int(got.ne(0).sum()) > 0


def test_bit_word_helpers_round_trip():
    rng = np.random.RandomState(5)
    bits = torch.from_numpy(rng.rand(3, 70) < 0.5)
    words = D.pack(bits, 3)
    assert words.dtype == torch.int32
    assert torch.equal(D.unpack(words, 70), bits)
    raw = rng.randint(0, 2**32, size=(4, 3), dtype=np.uint64).astype(np.uint32)
    t = D.to_tensor(raw, "cpu")
    assert np.array_equal(t.numpy().view(np.uint32), raw)
    want = np.array([[bin(int(v)).count("1") for v in row] for row in raw])
    assert np.array_equal(D.popcount(t).numpy(), want)
    w = torch.tensor([0, 2, -1], dtype=torch.int32)
    b = torch.tensor([31, 0, 3], dtype=torch.int32)
    got = D.gather_bits(t, w, b)
    exp = [[((int(row[0]) >> 31) & 1) == 1, ((int(row[2]) >> 0) & 1) == 1, False] for row in raw]
    assert got.tolist() == exp
