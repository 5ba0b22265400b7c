"""Reference solver tensors -> the port's tensors.

The JAX package's `Tables`/`State`/`PodX` (after `jax.device_get`, so every
leaf is a numpy array) become this package's NamedTuples of torch tensors,
field for field, with uint32 bit words viewed as int32. Both packages'
kernels can then be fed byte-identical inputs. No JAX import happens here:
the inputs are duck-typed NamedTuples with the reference's field names.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.device import to_tensor
from karpenter_tpu_torch.ops.encode import Reqs
from karpenter_tpu_torch.ops.kernels import VocabArrays
from karpenter_tpu_torch.solver.tpu_kernel import PodX, State, Tables


def _leaf(a, device) -> torch.Tensor:
    return to_tensor(np.asarray(a), device)


def reqs(r, device) -> Reqs:
    return Reqs(*(_leaf(getattr(r, f), device) for f in Reqs._fields))


def _convert(obj, cls, device):
    out = {}
    for name in cls._fields:
        v = getattr(obj, name)
        if name == "va":
            out[name] = VocabArrays.from_arrays(v.word2key, v.well_known, v.full_mask, device)
        elif hasattr(v, "mask") and hasattr(v, "minv"):
            out[name] = reqs(v, device)
        else:
            out[name] = _leaf(v, device)
    return cls(**out)


def tables(tb, device="cpu") -> Tables:
    return _convert(tb, Tables, torch.device(device))


def state(st, device="cpu") -> State:
    return _convert(st, State, torch.device(device))


def pod_x(xs, device="cpu") -> PodX:
    return _convert(xs, PodX, torch.device(device))


def run_x(rx, device="cpu"):
    """The reference's RunX (numpy leaves) -> tpu_runs.RunX."""
    from karpenter_tpu_torch.solver.tpu_runs import RunX

    dev = torch.device(device)
    return RunX(
        x=pod_x(rx.x, device),
        is_head=_leaf(rx.is_head, dev),
        bulk=_leaf(rx.bulk, dev),
        aff=_leaf(rx.aff, dev),
        run_rem=_leaf(rx.run_rem, dev),
    )
