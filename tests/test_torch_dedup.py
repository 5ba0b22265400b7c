"""K5's contract on the CPU: the port's `dedup_columns` (its plain path)
against the JAX package's `_dedup_decode_state`, bit for bit.

The port hands K5 the claim state's nine columns as they lie (three of
them bool) and the kernel reads them in place; the reference packs them
into one u32 matrix first. Each case builds the nine columns with numpy
from a seed, gives them to the reference as a State and to the port as
tensors with more rows than the n it asks for, and compares n_uniq, the
inverse index and the compacted rows exactly (`np.array_equal`).
"""

import os

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu import jaxsetup
from karpenter_tpu.ops.encode import Reqs as JReqs
from karpenter_tpu.solver import tpu as JT
from karpenter_tpu.solver import tpu_kernel as JK
from karpenter_tpu_torch.solver import tpu as PT

# the State's fields in the dedup layout, their numpy dtypes
FIELDS = ("mask", "exmask", "other", "notin", "defined", "gt", "lt", "minv", "alive")
DTYPES = (np.uint32, np.uint32, bool, bool, bool, np.int32, np.int32, np.int32, np.uint32)
EXTRA_ROWS = 3  # rows past n in every column: the port must read only the first n


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    """The reference side compiles without the persistent XLA cache (its
    cache writes have crashed workers); the setting is restored after."""
    old = os.environ.get("KARPENTER_COMPILATION_CACHE_DIR")
    os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""
    jaxsetup.ensure_compilation_cache()
    yield
    if old is None:
        del os.environ["KARPENTER_COMPILATION_CACHE_DIR"]
    else:
        os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = old
    jaxsetup.ensure_compilation_cache()


def _column(rng, rows: int, width: int, dtype) -> np.ndarray:
    if dtype is bool:
        return rng.integers(0, 2, size=(rows, width)).astype(bool)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, size=(rows, width), dtype=np.int64).astype(dtype)


def _columns(seed: int, n: int, widths: tuple, kind: str) -> list:
    """The nine columns, n + EXTRA_ROWS rows each. kind: "pool" (rows
    drawn from a pool of n // 8 + 2, so most repeat), "equal" (one row
    repeated) or "distinct" (every row its own, the first column holding
    the row's index)."""
    rng = np.random.default_rng(seed)
    rows = n + EXTRA_ROWS
    pool = {"pool": n // 8 + 2, "equal": 1, "distinct": rows}[kind]
    pick = rng.integers(0, pool, size=rows) if kind == "pool" else np.arange(rows) % pool
    cols = [_column(rng, pool, w, dt)[pick] for w, dt in zip(widths, DTYPES)]
    if kind == "distinct":
        first = next(k for k, w in enumerate(widths) if w)
        cols[first][:, 0] = np.arange(rows) if DTYPES[first] is not bool else np.arange(rows) % 2
    return cols


def _reference(cols: list, n: int):
    """(n_uniq, inv, compact) of the JAX package's decode on a State whose
    claim columns are `cols`."""
    r = {f: c for f, c in zip(FIELDS, cols)}
    N = cols[0].shape[0]
    st = JK.State(
        active=None, count=None, rank=None, tmpl=np.zeros(N, np.int32),
        creq=JReqs(*(r[f] for f in FIELDS[:8])), crequests=np.zeros((N, 1), np.int32), alive=r["alive"],
        cmax_alloc=None, n_claims=None,
        ereq=JReqs(*(np.zeros((0, 0), dt) for dt in DTYPES[:8])),
        eavail=np.zeros((0, 1), np.int32), trem=np.zeros((1, 1), np.int32), v_cnt=np.zeros((1, 1), np.int32),
        h_cnt=np.zeros((1, n), np.int32), rescap=None, held=None, hp_used=None,
    )
    small, compact = jax.device_get(JT._dedup_decode_state(st, n2=n, ecols=n))
    return int(small[0]), np.asarray(small[1]), np.asarray(compact)


def _port(cols: list, n: int):
    tensors = [torch.from_numpy(c.view(np.int32) if c.dtype == np.uint32 else c) for c in cols]
    return PT.dedup_columns(tensors, n)


# (n, widths of mask, exmask, other, notin, defined, gt, lt, minv, alive, rows)
CASES = {
    "state-300": (300, (3, 3, 4, 4, 4, 4, 4, 4, 2), "pool"),
    "one-column-64": (64, (0, 0, 0, 0, 0, 0, 0, 0, 5), "pool"),
    "bool-column-100": (100, (0, 0, 6, 0, 0, 0, 0, 0, 0), "pool"),
    "n-1": (1, (2, 2, 3, 3, 3, 3, 3, 3, 1), "pool"),
    "all-equal-200": (200, (3, 3, 4, 4, 4, 4, 4, 4, 2), "equal"),
    "all-distinct-200": (200, (3, 3, 4, 4, 4, 4, 4, 4, 2), "distinct"),
    "headline-widths-130": (130, (36, 36, 16, 16, 16, 16, 16, 16, 16), "pool"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dedup_columns_matches_reference(case):
    n, widths, kind = CASES[case]
    cols = _columns(len(case), n, widths, kind)
    want_n, want_inv, want_compact = _reference(cols, n)
    got_n, got_inv, got_compact = _port(cols, n)
    assert int(got_n) == want_n
    assert np.array_equal(got_inv.numpy(), want_inv)
    assert np.array_equal(got_compact.numpy().view(np.uint32), want_compact)
    if kind == "equal":
        assert want_n == 1
    if kind == "distinct":
        assert want_n == n


def test_dedup_columns_plain_is_the_packed_rows_plain():
    """dedup_columns' plain path is dedup_rows_plain of the widened rows,
    and decode_rows packs a State's columns in the dedup layout."""
    n, widths, _ = CASES["state-300"]
    cols = [torch.from_numpy(c.view(np.int32) if c.dtype == np.uint32 else c) for c in _columns(1, n, widths, "pool")]
    packed = torch.cat([c[:n].to(torch.int32) for c in cols], dim=1)
    for a, b in zip(PT.dedup_columns(cols, n), PT.dedup_rows_plain(packed)):
        assert torch.equal(a, b)
    for a, b in zip(PT.dedup_rows(packed), PT.dedup_rows_plain(packed)):
        assert torch.equal(a, b)
