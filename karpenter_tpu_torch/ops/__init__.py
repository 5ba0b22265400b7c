"""Tensor encodings and the requirement algebra.

- `vocab`   — label-value interning + exact int32 resource scaling
- `encode`  — Requirements -> bitmask arrays (numpy)
- `kernels` — the requirement algebra on torch tensors
"""

from karpenter_tpu_torch.ops.encode import Reqs, decode_row, encode_requirements
from karpenter_tpu_torch.ops.vocab import ResourceTable, UnsupportedProblem, Vocab

__all__ = [
    "ResourceTable",
    "UnsupportedProblem",
    "Vocab",
    "Reqs",
    "encode_requirements",
    "decode_row",
]
