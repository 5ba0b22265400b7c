from karpenter_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taints

__all__ = [
    "ALLOW_UNDEFINED_WELL_KNOWN_LABELS",
    "Requirement",
    "Requirements",
    "Taints",
]
