"""StaticDrift: replace drifted nodes owned by static (replica-count)
NodePools — the only disruption method allowed to touch static pools.

A copy of the reference's `controllers/disruption/staticdrift.py`
(staticdrift.go:35-117): group candidates by nodepool, skip pools
mid-scale-down, reserve node count against the pool's `nodes` limit, and
emit one replace-command per drifted node whose replacement is a bare
NodeClaimTemplate launch (no pods — the static pool's capacity is
workload-independent). It runs no device code; `device` is accepted so
that every method takes the same arguments.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.cloudprovider.types import InstanceTypes
from karpenter_tpu_torch.controllers.disruption.helpers import (
    build_budget_mapping,
    build_candidates,
)
from karpenter_tpu_torch.controllers.disruption.types import REASON_DRIFTED, Candidate, Command
from karpenter_tpu_torch.controllers.static import node_limit
from karpenter_tpu_torch.options import Options
from karpenter_tpu_torch.solver.nodes import NodeClaimTemplate

# names replacement claims `<pool>-staticdrift-<n>` (process-wide, as the
# reference's)
_replacement_seq = [0]


class StaticDrift:
    """staticdrift.go:35 StaticDrift subreconciler."""

    reason = REASON_DRIFTED

    def __init__(
        self,
        kube,
        cluster,
        cloud_provider,
        clock,
        options: Optional[Options] = None,
        recorder=None,
        force_oracle: bool = False,
        device=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud_provider
        self.clock = clock
        self.opts = options or Options()
        self.recorder = recorder

    def should_disrupt(self, c: Candidate) -> bool:
        """staticdrift.go:51: static-owned and Drifted."""
        return c.owned_by_static_nodepool() and c.drifted()

    def compute_commands(self) -> list[Command]:
        candidates = build_candidates(
            self.kube, self.cluster, self.cloud, self.clock,
            self.should_disrupt, disruption_class="eventual",  # staticdrift.go:112
        )
        if not candidates:
            return []
        budgets = build_budget_mapping(self.kube, self.cluster, self.reason)
        by_pool: dict[str, list[Candidate]] = {}
        for c in candidates:
            by_pool.setdefault(c.nodepool_name, []).append(c)

        cmds: list[Command] = []
        for np_name, cands in by_pool.items():
            np = cands[0].node_pool
            allowed = budgets.allowed.get(np_name, 0)
            if allowed == 0:
                continue
            # staticdrift.go:76: don't replace while a scale-down is in
            # flight (more running+pending than desired replicas)
            active, _, pending = self.cluster.nodepool_state.node_counts(np_name)
            if active + pending > (np.replicas or 0):
                continue
            max_drifts = min(allowed, len(cands))
            # staticdrift.go:87: reserve replacements against the node limit
            granted = self.cluster.nodepool_state.reserve_node_count(
                np_name, node_limit(np), max_drifts
            )
            for c in cands[:granted]:
                nct = NodeClaimTemplate(np)
                replacement = nct.to_node_claim(
                    nct.requirements.copy(), InstanceTypes()
                )
                _replacement_seq[0] += 1
                replacement.metadata.name = (
                    f"{np_name}-staticdrift-{_replacement_seq[0]:05d}"
                )
                cmds.append(
                    Command(
                        reason=self.reason,
                        candidates=[c],
                        replacements=[replacement],
                        reserved_pool=np_name,
                        reserved_count=1,
                    )
                )
        return cmds
