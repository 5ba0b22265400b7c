"""Static-capacity NodePools: for now only the pool's node-count limit,
which StaticDrift reserves replacements against.

A copy of part of the reference's `controllers/static.py` (static
provisioning and deprovisioning, provisioning/controller.go:69-118 and
deprovisioning/controller.go:75-240, come with the rest of the Operator's
controllers).
"""

from __future__ import annotations

from karpenter_tpu_torch.api.objects import NodePool


def node_limit(np: NodePool) -> "float | int":
    """The pool's `nodes` limit as a node count; unlimited when absent.
    Limits are stored as integer milli-units (utils/resources.py: a limit
    of "2" is 2000), so the count conversion stays integer."""
    raw = np.limits.get("nodes")
    return float("inf") if raw is None else raw // 1000
