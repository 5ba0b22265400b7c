"""Disruption candidates and commands.

Reference pkg/controllers/disruption/types.go:73-216.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    COND_EMPTY,
    NodePool,
    Pod,
)
from karpenter_tpu_torch.controllers.state import StateNode
from karpenter_tpu_torch.solver.nodes import SchedulingNodeClaim

# disruption reasons (reference apis/v1 DisruptionReason)
REASON_UNDERUTILIZED = "underutilized"
REASON_EMPTY = "empty"
REASON_DRIFTED = "drifted"


@dataclass
class Candidate:
    """types.go:73 Candidate: a disruptable node plus everything the
    decision needs."""

    state_node: StateNode
    node_pool: NodePool
    instance_type_name: str
    capacity_type: str
    zone: str
    price: float  # current offering price (MAX if unknown)
    reschedulable_pods: list[Pod] = field(default_factory=list)
    disruption_cost: float = 0.0

    @property
    def name(self) -> str:
        return self.state_node.name

    @property
    def nodepool_name(self) -> str:
        return self.node_pool.name

    def claim_name(self) -> Optional[str]:
        claim = self.state_node.node_claim
        return claim.name if claim is not None else None

    def is_empty(self) -> bool:
        return not self.reschedulable_pods

    def owned_by_static_nodepool(self) -> bool:
        """types.go:83: static pools scale via their replica controllers;
        only StaticDrift may disrupt them."""
        return self.node_pool.replicas is not None

    def condition(self, cond: str) -> bool:
        claim = self.state_node.node_claim
        return claim is not None and claim.status.conditions.get(cond) == "True"

    def consolidatable(self) -> bool:
        return self.condition(COND_CONSOLIDATABLE)

    def drifted(self) -> bool:
        return self.condition(COND_DRIFTED)

    def empty_condition(self) -> bool:
        return self.condition(COND_EMPTY)


DECISION_DELETE = "delete"
DECISION_REPLACE = "replace"
DECISION_NOOP = "no-op"


@dataclass
class Command:
    """types.go:150 Command: what to do with a candidate set."""

    reason: str
    candidates: list[Candidate] = field(default_factory=list)
    replacements: list[SchedulingNodeClaim] = field(default_factory=list)
    # node-count reservations held against a static pool's `nodes` limit
    # (statenodepool.go ReserveNodeCount); released on launch — or by the
    # controller if the command is discarded or fails validation
    reserved_pool: Optional[str] = None
    reserved_count: int = 0

    @property
    def decision(self) -> str:
        if not self.candidates:
            return DECISION_NOOP
        return DECISION_REPLACE if self.replacements else DECISION_DELETE

    def __repr__(self) -> str:
        return (
            f"Command({self.decision}, reason={self.reason}, "
            f"candidates={[c.name for c in self.candidates]}, "
            f"replacements={len(self.replacements)})"
        )


def command_savings(cmd: Command) -> float:
    """$/hour saved by executing the command: the removed candidates'
    current offering prices minus (for replace) the cheapest launch price
    the replacement could resolve to. consolidation.go:199 filterByPrice
    bounds every replacement option strictly below the current total, so
    this is positive for every non-noop command — the removal-set
    search's ranking objective (setsweep.py), where the prefix search's
    objective was simply the prefix length.

    A candidate with an unknown price carries MAX_FLOAT
    (helpers.py _candidate_price); such a command's savings are
    unknowable, not infinite, so it ranks at 0.0 rather than poisoning
    the search with inf/NaN arithmetic."""
    import math

    from karpenter_tpu_torch.cloudprovider.types import MAX_FLOAT

    if not cmd.candidates:
        return 0.0
    if any(c.price >= MAX_FLOAT for c in cmd.candidates):
        return 0.0
    saved = sum(c.price for c in cmd.candidates)
    for claim in cmd.replacements:
        prices = [
            it.offerings.available().cheapest_launch_price(claim.requirements)
            for it in claim.instance_type_options
        ]
        prices = [p for p in prices if p < MAX_FLOAT]
        saved -= min(prices) if prices else MAX_FLOAT
    return saved if math.isfinite(saved) else 0.0


POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def eviction_cost(pod: Pod) -> float:
    """utils/disruption/disruption.go:49 EvictionCost, exactly: base 1.0 +
    deletion-cost annotation / 2^27 + priority / 2^25, clamped to
    [-10, 10]. A malformed annotation is ignored (the reference logs and
    continues)."""
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost += float(raw) / (2.0 ** 27)
        except ValueError:
            pass
    cost += float(pod.priority) / (2.0 ** 25)
    return max(-10.0, min(10.0, cost))


def lifetime_remaining(clock, claim) -> float:
    """utils/disruption/disruption.go:37 LifetimeRemaining: fraction of
    expireAfter left, in [0, 1]; 1.0 when expiry is disabled — nodes near
    expiry are cheaper to disrupt."""
    if claim is None or claim.expire_after_seconds is None:
        return 1.0
    total = float(claim.expire_after_seconds)
    if total <= 0:
        return 1.0
    age = clock.now() - claim.metadata.creation_timestamp
    return max(0.0, min(1.0, (total - age) / total))


def disruption_cost(pods: list[Pod], clock=None, claim=None) -> float:
    """ReschedulingCost x LifetimeRemaining (disruption.go:72 +
    types.go:132): the candidate-ordering key."""
    cost = sum(eviction_cost(p) for p in pods)
    if clock is not None:
        cost *= lifetime_remaining(clock, claim)
    return cost
