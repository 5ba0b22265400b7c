"""Static-capacity NodePools: maintain a fixed replica count of nodes,
independent of pending pods (feature-gated, like the reference).

Reference pkg/controllers/static/:
- provisioning/controller.go:69-118 (scale up to spec.replicas)
- deprovisioning/controller.go:75-240 (scale down, emptiest first)
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import NodeClaim, NodePool, ObjectMeta
from karpenter_tpu_torch.controllers.kube import NotFound, SimKube
from karpenter_tpu_torch.controllers.state import Cluster
from karpenter_tpu_torch.events import Event, Recorder
from karpenter_tpu_torch.solver.nodes import NodeClaimTemplate
from karpenter_tpu_torch import metrics

STATIC_NODES = metrics.REGISTRY.gauge(
    "karpenter_static_nodepool_nodes",
    "Nodes owned by static nodepools.",
    ("nodepool",),
)

_static_seq = [0]


def node_limit(np: NodePool) -> "float | int":
    """The pool's `nodes` limit as a node count; unlimited when absent.
    Limits are stored as integer milli-units (utils/resources.py: a limit
    of "2" is 2000), so the count conversion stays integer."""
    raw = np.limits.get("nodes")
    return float("inf") if raw is None else raw // 1000


def owned_claims(kube: SimKube, nodepool: str) -> list[NodeClaim]:
    """Non-deleting NodeClaims owned by the pool."""
    return [
        c
        for c in kube.list("NodeClaim")
        if c.nodepool_name == nodepool and c.metadata.deletion_timestamp is None
    ]


class StaticProvisioning:
    """Scale static pools up to replicas (provisioning/controller.go:69)."""

    def __init__(self, kube: SimKube, cluster: Cluster, recorder: Optional[Recorder] = None):
        self.kube = kube
        self.cluster = cluster
        self.recorder = recorder

    def reconcile_all(self) -> int:
        created = 0
        for np in self.kube.list("NodePool"):
            if np.replicas is None:
                continue
            # provisioning/controller.go:83: count via NodePoolState —
            # pending-disruption claims count as active (the disruption
            # controller is already creating their replacements)
            active, _, pending = self.cluster.nodepool_state.node_counts(np.name)
            STATIC_NODES.set(float(active), {"nodepool": np.name})
            if active + pending >= np.replicas:
                continue
            # provisioning/controller.go:93: reserve against the node limit
            # so concurrent scale decisions can't burst over it
            # pending-disruption claims count as active (their replacements
            # are already being created), so the deficit subtracts both
            grant = self.cluster.nodepool_state.reserve_node_count(
                np.name, node_limit(np), np.replicas - active - pending
            )
            for _ in range(grant):
                self._create_claim(np)
                # the create marked the claim active (informer), so the
                # reservation converts immediately (provisioner.go:166)
                self.cluster.nodepool_state.release_node_count(np.name, 1)
                created += 1
        return created

    def _create_claim(self, np: NodePool) -> None:
        nct = NodeClaimTemplate(np)
        nc = nct.to_node_claim(nct.requirements.copy(), [])
        _static_seq[0] += 1
        nc.metadata.name = f"{np.name}-static-{_static_seq[0]:05d}"
        self.kube.create("NodeClaim", nc)
        if self.recorder:
            self.recorder.publish(
                Event(
                    "NodeClaim", nc.metadata.name, "Normal", "StaticProvisioned",
                    f"maintaining {np.replicas} replicas",
                )
            )


class StaticDeprovisioning:
    """Scale static pools down to replicas, emptiest nodes first
    (deprovisioning/controller.go:75)."""

    def __init__(self, kube: SimKube, cluster: Cluster, recorder: Optional[Recorder] = None):
        self.kube = kube
        self.cluster = cluster
        self.recorder = recorder

    def reconcile_all(self) -> int:
        deleted = 0
        for np in self.kube.list("NodePool"):
            if np.replicas is None:
                continue
            owned = owned_claims(self.kube, np.name)
            # deprovisioning/controller.go:84: surplus from NodePoolState
            active, _, pending = self.cluster.nodepool_state.node_counts(np.name)
            if pending > 0:
                # a StaticDrift rollout is replacing claims; scaling down
                # now could delete the in-flight replacement and roll the
                # disruption back — wait for the rollout to finish
                continue
            surplus = min(len(owned), active) - np.replicas
            if surplus <= 0:
                continue
            # emptiest (fewest pods) first, newest as tiebreak
            def pod_count(claim: NodeClaim) -> int:
                name = claim.status.node_name
                return len(self.cluster.pods_on(name)) if name else 0

            owned.sort(
                key=lambda c: (pod_count(c), -c.metadata.creation_timestamp)
            )
            for claim in owned[:surplus]:
                try:
                    self.kube.delete("NodeClaim", claim.name)
                    deleted += 1
                except NotFound:
                    continue
                if self.recorder:
                    self.recorder.publish(
                        Event(
                            "NodeClaim", claim.name, "Normal",
                            "StaticDeprovisioned",
                            f"scaling down to {np.replicas} replicas",
                        )
                    )
        return deleted
