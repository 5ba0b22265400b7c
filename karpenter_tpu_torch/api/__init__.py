from karpenter_tpu_torch.api import labels
from karpenter_tpu_torch.api.objects import (
    Node,
    NodeClaim,
    NodePool,
    NodeSelectorRequirement,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)

__all__ = [
    "labels",
    "Node",
    "NodeClaim",
    "NodePool",
    "NodeSelectorRequirement",
    "ObjectMeta",
    "Pod",
    "PodAffinityTerm",
    "Taint",
    "Toleration",
    "TopologySpreadConstraint",
    "WeightedPodAffinityTerm",
]
