"""Resource-list arithmetic with exact integer milli-unit quantities.

A ResourceList is a plain dict[str, int] mapping resource name -> milli-units
(see karpenter_tpu.utils.quantity). Semantics mirror the reference helpers in
pkg/utils/resources/resources.go:30-163 (Merge, Subtract, Fits,
Cmp, MaxResources, RequestsForPods).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Mapping

from karpenter_tpu_torch.utils import quantity

if TYPE_CHECKING:  # pragma: no cover
    from karpenter_tpu_torch.api.objects import Container, Pod

ResourceList = dict[str, int]

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
HUGEPAGES_PREFIX = "hugepages-"

# Resources every provider is expected to report on its instance types
# (reference: pkg/apis/v1/labels.go WellKnownResources).
WELL_KNOWN_RESOURCES = frozenset({CPU, MEMORY, EPHEMERAL_STORAGE, PODS})


def parse_list(spec: Mapping[str, str | int | float]) -> ResourceList:
    """Build a ResourceList from human-readable quantities, e.g. {"cpu": "100m"}."""
    return {name: quantity.parse(v) for name, v in spec.items()}


def merge(*lists: Mapping[str, int]) -> ResourceList:
    """Sum of resource lists (reference resources.go:52 Merge)."""
    result: ResourceList = {}
    for rl in lists:
        for name, v in rl.items():
            result[name] = result.get(name, 0) + v
    return result


def merge_into(dest: ResourceList, src: Mapping[str, int]) -> ResourceList:
    for name, v in src.items():
        dest[name] = dest.get(name, 0) + v
    return dest


def subtract(lhs: Mapping[str, int], rhs: Mapping[str, int]) -> ResourceList:
    """lhs - rhs over lhs's keys (reference resources.go:83 Subtract)."""
    return {name: v - rhs.get(name, 0) for name, v in lhs.items()}


def subtract_from(dest: ResourceList, src: Mapping[str, int]) -> None:
    for name, v in src.items():
        dest[name] = dest.get(name, 0) - v


def max_resources(*lists: Mapping[str, int]) -> ResourceList:
    """Element-wise max (reference resources.go:121 MaxResources)."""
    result: ResourceList = {}
    for rl in lists:
        for name, v in rl.items():
            if name not in result or v > result[name]:
                result[name] = v
    return result


def fits(candidate: Mapping[str, int], total: Mapping[str, int]) -> bool:
    """True if candidate <= total element-wise.

    Mirrors reference resources.go:150 Fits: any negative quantity in `total`
    means nothing fits; resources missing from `total` count as zero.
    """
    for v in total.values():
        if v < 0:
            return False
    for name, v in candidate.items():
        if v > total.get(name, 0):
            return False
    return True


def ceiling(
    containers: Iterable["Container"] = (),
    init_containers: Iterable["Container"] = (),
    overhead: Mapping[str, int] | None = None,
) -> ResourceList:
    """Effective pod requests from container-level specs (reference
    resources.go:113 Ceiling / KEP-753 sidecar semantics):

    - init containers run sequentially: the pod must fit the LARGEST of
      them, each stacked on the restartable (sidecar) init containers that
      started before it and keep running;
    - restartable init containers ("Always") are sidecars: their requests
      ride alongside the main containers for the pod's whole life;
    - the result is max(sum(main) + sum(sidecars), rolling init max),
      plus pod overhead (pod.Spec.Overhead, RuntimeClass);
    - a resource present only in a container's limits acts as its request
      (resources.go:96 MergeResourceLimitsIntoRequests).
    """
    restartable_init: ResourceList = {}
    init_peak: ResourceList = {}
    for c in init_containers:
        reqs = c.effective_requests()
        if c.restart_policy == "Always":
            restartable_init = merge(restartable_init, reqs)
            stacked = dict(restartable_init)
        else:
            stacked = merge(reqs, restartable_init)
        init_peak = max_resources(init_peak, stacked)
    main = merge(*(c.effective_requests() for c in containers))
    total = merge(main, restartable_init)
    total = max_resources(total, init_peak)
    if overhead:
        total = merge(total, overhead)
    return total


def requests_for_pods(pods: Iterable["Pod"]) -> ResourceList:
    """Total requests of a set of pods plus a `pods` count resource
    (reference resources.go:30 RequestsForPods)."""
    pods = list(pods)
    result = merge(*(p.requests for p in pods))
    result[PODS] = len(pods) * 1000
    return result


def is_zero(rl: Mapping[str, int]) -> bool:
    return all(v == 0 for v in rl.values())


def to_string(rl: Mapping[str, int]) -> str:
    if not rl:
        return "{}"
    return "{" + ",".join(f"{k}: {quantity.format_milli(v)}" for k, v in sorted(rl.items())) + "}"
