"""Reference state -> the port's state.

- Solver tensors: the JAX package's `Tables`/`State`/`PodX` (after
  `jax.device_get`, so every leaf is a numpy array) become this package's
  NamedTuples of torch tensors, field for field, with uint32 bit words
  viewed as int32. Both packages' kernels can then be fed byte-identical
  inputs. No JAX import happens here: the inputs are duck-typed
  NamedTuples with the reference's field names.
- A cluster (`cluster`, `candidates`): the API objects of a control plane,
  as the JSON-able dicts `api.codec.to_jsonable` makes of them, become the
  port's SimKube with a wired Cluster cache, a FakeClock and a KWOK cloud
  provider, so that a consolidation sweep sees the same cluster on both
  sides.
"""

from __future__ import annotations

from typing import NamedTuple

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


class World(NamedTuple):
    """A cluster on the port's side: the API store, its wired cache, the
    clock and the cloud provider."""

    kube: object
    cluster: object
    clock: object
    cloud: object


def cluster(objects: list, instance_types: list, now: float) -> World:
    """The port's cluster from `objects`, JSON-able dicts of NodePools,
    NodeClaims, Nodes, Pods, DaemonSets and Namespaces (each with its
    "__type__"), created in list order, and `instance_types`, JSON-able
    InstanceTypes for the KWOK provider; the clock reads `now`.

    The Cluster cache orders its state nodes by first sight, and the sweeps
    number existing slots in that order, so pass each NodeClaim (with its
    provider id set) before its Node, in the source cluster's
    `state_nodes()` order."""
    from karpenter_tpu_torch.api.codec import from_jsonable
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.controllers.kube import DaemonSet, FakeClock, Namespace, SimKube
    from karpenter_tpu_torch.controllers.state import Cluster, wire_informers

    clock = FakeClock(now)
    kube = SimKube(clock)
    cache = Cluster(clock)
    wire_informers(kube, cache)
    for d in objects:
        kind = d["__type__"]
        # DaemonSet and Namespace are the store's own dataclasses, outside
        # the codec's registry
        if kind == "DaemonSet":
            obj = DaemonSet(name=d["name"], pod_template=from_jsonable(d["pod_template"]))
        elif kind == "Namespace":
            obj = Namespace(name=d["name"], labels=dict(d["labels"]))
        else:
            obj = from_jsonable(d)
        kube.create(kind, obj)
    types = [from_jsonable(t) for t in instance_types]
    return World(kube, cache, clock, KwokCloudProvider(kube, clock, instance_types=types))


def candidates(kube, cluster, cloud, clock, names) -> list:
    """The port's consolidation Candidates for the nodes `names`, in the
    reference's order (disruption cost, then name; consolidation.py:92).
    Raises if a name is not a disruptable candidate on this side."""
    from karpenter_tpu_torch.controllers.disruption.helpers import build_candidates

    wanted = set(names)
    out = build_candidates(kube, cluster, cloud, clock, lambda c: c.name in wanted)
    missing = wanted - {c.name for c in out}
    if missing:
        raise ValueError(f"not disruptable candidates in the port's cluster: {sorted(missing)}")
    out.sort(key=lambda c: (c.disruption_cost, c.name))
    return out
