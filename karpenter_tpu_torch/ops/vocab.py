"""Per-solve interning of label keys/values and exact resource scaling.

Label values, requirement keys, and instance-type counts vary per Solve; the
vocab is built once per Solve outside jit (SURVEY.md §7 "hard parts" #2) and
determines the static tensor shapes the kernels compile against. Value ids are
assigned in *sorted* order per key so argmin-by-id tie-breaks in the kernels
match the (determinized) oracle's sorted-iteration tie-breaks.

Resources are exact integer milli-quantities (karpenter_tpu.utils.quantity).
The TPU kernels use int32; to stay exact we divide every resource by the GCD
of all observed values of that resource. If the scaled range still overflows
int32 (pathological byte-granular requests on TB nodes) the problem is
rejected with UnsupportedProblem and the caller falls back to the oracle.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional

import numpy as np

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.scheduling.requirements import Requirement, Requirements

WORD_BITS = 32
# Safety bound: scaled resource values must leave headroom for one addition.
_MAX_SCALED = 1 << 30
# Reserved name prefix for phantom vocab keys added by shape bucketing
# (solver/buckets.py re-exports this): real label keys are DNS-ish and
# never start with a parenthesis, so collision is impossible.
PAD_KEY_PREFIX = "(bucket-pad-"


class UnsupportedProblem(Exception):
    """The problem can't be encoded exactly; use the oracle solver."""


class Vocab:
    """Key + per-key value interning for one Solve.

    The hostname key is handled *structurally* by the solver (a node IS its
    hostname domain) and is excluded here; requirements on it never enter the
    mask tensors.
    """

    def __init__(self) -> None:
        self._values: dict[str, set[str]] = {}
        self._finalized = False
        self.excluded_keys = frozenset({well_known.HOSTNAME_LABEL_KEY})

    # -- building --------------------------------------------------------

    def observe_requirements(self, reqs: Requirements) -> None:
        for r in reqs.values():
            self.observe_requirement(r)

    def observe_requirement(self, r: Requirement) -> None:
        if r.key in self.excluded_keys:
            return
        bucket = self._values.setdefault(r.key, set())
        bucket.update(r.values)

    def observe_labels(self, labels: Mapping[str, str]) -> None:
        for k, v in labels.items():
            k = well_known.NORMALIZED_LABELS.get(k, k)
            if k in self.excluded_keys:
                continue
            self._values.setdefault(k, set()).add(v)

    # -- finalizing ------------------------------------------------------

    def finalize(self, pad_words=None, pad_keys=None) -> None:
        """Freeze: assign key ids (sorted) and value ids (sorted per key),
        compute the flattened word layout.

        pad_words/pad_keys (optional, solver/buckets.py ladder callables)
        bucket the layout for compiled-shape stability: pad_words pads each
        key's word count, pad_keys the key count. Phantom word bits are
        semantically identical to the tail bits of a non-multiple-of-32
        value count (never in full_mask, never set by any row); phantom
        keys carry a reserved-prefix name, one zero word, no values, and
        stay defined=False in every encoded row — invisible to the
        requirement algebra (ops/kernels.py gates everything on defined)."""
        assert not self._finalized
        self.keys: list[str] = sorted(self._values)
        if pad_keys is not None:
            want = pad_keys(len(self.keys))
            for i in range(want - len(self.keys)):
                # ids are positional and phantom keys are appended after
                # the sorted real list, so real key ids never shift
                name = f"{PAD_KEY_PREFIX}{i})"
                self.keys.append(name)
                self._values[name] = set()
        self.key_index: dict[str, int] = {k: i for i, k in enumerate(self.keys)}
        self.values: list[list[str]] = [sorted(self._values[k]) for k in self.keys]
        self.value_index: list[dict[str, int]] = [
            {v: i for i, v in enumerate(vals)} for vals in self.values
        ]
        self.words_per_key: list[int] = [
            max(1, (len(vals) + WORD_BITS - 1) // WORD_BITS) for vals in self.values
        ]
        if pad_words is not None:
            self.words_per_key = [pad_words(w) for w in self.words_per_key]
        self.word_offset: list[int] = []
        off = 0
        for w in self.words_per_key:
            self.word_offset.append(off)
            off += w
        self.total_words = off
        self.num_keys = len(self.keys)
        # [TW] -> key id for segment reductions
        self.word2key = np.zeros(self.total_words, dtype=np.int32)
        for k, (o, w) in enumerate(zip(self.word_offset, self.words_per_key)):
            self.word2key[o : o + w] = k
        # one-hot [TW, K] for matmul-based per-key reductions (MXU-friendly)
        self.onehot = np.zeros((self.total_words, self.num_keys), dtype=np.float32)
        self.onehot[np.arange(self.total_words), self.word2key] = 1.0
        # full (Exists) mask: valid value bits set, padding bits clear
        self.full_mask = np.zeros(self.total_words, dtype=np.uint32)
        for k, vals in enumerate(self.values):
            for vid in range(len(vals)):
                self._set_bit(self.full_mask, k, vid)
        self.well_known_mask = np.array(
            [k in well_known.WELL_KNOWN_LABELS for k in self.keys], dtype=bool
        )
        self._finalized = True

    # -- lookups ---------------------------------------------------------

    def key_id(self, key: str) -> Optional[int]:
        return self.key_index.get(key)

    def value_id(self, key_id: int, value: str) -> Optional[int]:
        return self.value_index[key_id].get(value)

    def _set_bit(self, flat: np.ndarray, key_id: int, value_id: int) -> None:
        word = self.word_offset[key_id] + value_id // WORD_BITS
        flat[word] |= np.uint32(1 << (value_id % WORD_BITS))


class ResourceTable:
    """Fixed resource-dimension layout with exact per-resource GCD scaling."""

    def __init__(self) -> None:
        self._observed: dict[str, list[int]] = {}
        self._finalized = False

    def observe(self, rl: Mapping[str, int]) -> None:
        for name, v in rl.items():
            self._observed.setdefault(name, []).append(int(v))

    def finalize(self) -> None:
        assert not self._finalized
        self.names: list[str] = sorted(self._observed)
        self.index: dict[str, int] = {n: i for i, n in enumerate(self.names)}
        self.scale: list[int] = []
        for n in self.names:
            vals = [abs(v) for v in self._observed[n] if v != 0]
            g = 0
            for v in vals:
                g = math.gcd(g, v)
            g = g or 1
            self.scale.append(g)
            if vals and max(vals) // g >= _MAX_SCALED:
                raise UnsupportedProblem(
                    f"resource {n!r} range {max(vals)}/{g} overflows the exact "
                    "int32 encoding"
                )
        self.num_resources = len(self.names)
        self._finalized = True

    def encode(self, rl: Mapping[str, int]) -> np.ndarray:
        """ResourceList -> exact scaled int32 row. Values must be observed
        quantities (or sums thereof), so division is exact by construction."""
        row = np.zeros(self.num_resources, dtype=np.int64)
        for name, v in rl.items():
            i = self.index.get(name)
            if i is None:
                # A request for a resource no entity provides: encode the fact
                # by rejecting — callers observe() every relevant list first.
                raise UnsupportedProblem(f"resource {name!r} was never observed")
            q, r = divmod(int(v), self.scale[i])
            if r != 0:
                raise UnsupportedProblem(
                    f"resource {name!r} value {v} not divisible by scale {self.scale[i]}"
                )
            if q >= _MAX_SCALED:
                raise UnsupportedProblem(
                    f"resource {name!r} scaled value {q} overflows the exact "
                    "int32 encoding"
                )
            row[i] = q
        return row.astype(np.int32)

    def decode(self, row: np.ndarray) -> dict[str, int]:
        return {
            n: int(row[i]) * self.scale[i]
            for i, n in enumerate(self.names)
            if row[i] != 0
        }
