from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    CreateError,
    InstanceType,
    InstanceTypeOverhead,
    InstanceTypes,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
    Offering,
    Offerings,
    RepairPolicy,
)

__all__ = [
    "CloudProvider",
    "CreateError",
    "InstanceType",
    "InstanceTypeOverhead",
    "InstanceTypes",
    "InsufficientCapacityError",
    "NodeClaimNotFoundError",
    "NodeClassNotReadyError",
    "Offering",
    "Offerings",
    "RepairPolicy",
]
