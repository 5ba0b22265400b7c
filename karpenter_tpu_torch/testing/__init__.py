from karpenter_tpu_torch.testing.fixtures import (
    reset_rng,
    make_diverse_pods,
    make_generic_pods,
    make_pod_affinity_pods,
    make_pod_anti_affinity_pods,
    make_preference_pods,
    make_topology_spread_pods,
    node_pool,
    pod,
)

__all__ = [
    "reset_rng",
    "make_diverse_pods",
    "make_generic_pods",
    "make_pod_affinity_pods",
    "make_pod_anti_affinity_pods",
    "make_preference_pods",
    "make_topology_spread_pods",
    "node_pool",
    "pod",
]
