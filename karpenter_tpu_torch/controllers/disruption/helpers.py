"""Disruption helpers: the scheduling simulation that referees a removal
(SimulateScheduling), and candidate discovery with prices.

A copy of the reference's `controllers/disruption/helpers.py`
(helpers.go:52-143 SimulateScheduling, :174 GetCandidates, types.go:73-134
the candidate filters, :231 BuildDisruptionBudgetMapping).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.cloudprovider.types import MAX_FLOAT
from karpenter_tpu_torch.controllers.disruption.types import Candidate, disruption_cost
from karpenter_tpu_torch.controllers.state import Cluster, cluster_source, is_reschedulable
from karpenter_tpu_torch.options import Options
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.solver.hybrid import TorchHybridScheduler
from karpenter_tpu_torch.solver.oracle import Results, SchedulerOptions
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.utils.pdb import PDBLimits


@dataclass
class SimResults:
    """helpers.go:34 scheduling results wrapper."""

    results: Results
    pods: list[Pod]
    used_tpu: bool = False  # which solver produced the simulation

    def all_pods_scheduled(self) -> bool:
        return not self.results.pod_errors and not self.results.timed_out

    def non_empty_new_claims(self):
        return [c for c in self.results.new_node_claims if c.pods]


def simulate_scheduling(
    kube,
    cluster: Cluster,
    cloud_provider,
    candidates: list[Candidate],
    options: Optional[Options] = None,
    force_oracle: bool = False,
    device=None,
) -> SimResults:
    """helpers.go:52 SimulateScheduling: solve the cluster as if the
    candidates were gone — their reschedulable pods plus all pending pods
    against every *other* node.

    The solve goes through `TorchHybridScheduler` on `device` (None = the
    card, "cpu" for the plain versions); `force_oracle=True` runs the
    port's sequential oracle alone, the referee of the consolidation
    sweeps."""
    opts = options or Options()
    candidate_names = {c.name for c in candidates}

    # deleting nodes' pods + candidates' pods + pending pods (helpers.go:84)
    pods: list[Pod] = []
    seen: set[str] = set()

    def add(ps):
        for p in ps:
            if p.uid not in seen:
                seen.add(p.uid)
                pods.append(p.deep_copy())

    for c in candidates:
        add(c.reschedulable_pods)
    for sn in cluster.state_nodes():
        if sn.name in candidate_names:
            continue
        if sn.marked_for_deletion or sn.deleting():
            add(p for p in cluster.pods_on(sn.name) if is_reschedulable(p))
    add(kube.pending_pods())

    node_pools = [np for np in kube.list("NodePool") if np.replicas is None]
    its_by_pool = {np.name: cloud_provider.get_instance_types(np) for np in node_pools}
    daemonset_pods = [ds.pod_template for ds in kube.list("DaemonSet")]

    views = [
        v
        for v in cluster.schedulable_node_views()
        if v.name not in candidate_names
    ]
    # pods on removed nodes aren't "scheduled" in the sim
    topology = Topology(
        node_pools,
        its_by_pool,
        pods,
        cluster=cluster_source(kube, cluster, frozenset(candidate_names)),
        state_node_views=views,
    )
    scheduler = TorchHybridScheduler(
        node_pools,
        its_by_pool,
        topology,
        views,
        daemonset_pods,
        SchedulerOptions(
            timeout_seconds=opts.solve_timeout_seconds,
            tpu_min_pods=opts.tpu_min_pods,
        ),
        force_oracle=force_oracle,
        device=device,
    )
    results = scheduler.solve(pods)
    return SimResults(results=results, pods=pods, used_tpu=bool(scheduler.used_tpu))


# ---------------------------------------------------------------------------
# candidates


def _build_candidate(
    sn, nodepools, cloud_provider, pdb_limits: PDBLimits, now: float
) -> Optional[Candidate]:
    """types.go:73 NewCandidate filters + statenode.go:202
    ValidateNodeDisruptable."""
    if not sn.owned() or sn.node is None or sn.node_claim is None:
        return None
    if not sn.registered() or not sn.initialized():
        return None
    if sn.marked_for_deletion or sn.deleting():
        return None
    if sn.nominated(now):
        return None
    labels = sn.labels()
    np_name = labels.get(well_known.NODEPOOL_LABEL_KEY)
    node_pool = nodepools.get(np_name)
    if node_pool is None:
        return None
    # do-not-disrupt on the node (statenode.go:234); pod-level checks happen
    # in build_candidates where the pod list is resolved
    if sn.node.metadata.annotations.get(well_known.DO_NOT_DISRUPT_ANNOTATION_KEY) == "true":
        return None
    return Candidate(
        state_node=sn,
        node_pool=node_pool,
        instance_type_name=labels.get(well_known.INSTANCE_TYPE_LABEL_KEY, ""),
        capacity_type=labels.get(well_known.CAPACITY_TYPE_LABEL_KEY, ""),
        zone=labels.get(well_known.TOPOLOGY_ZONE_LABEL_KEY, ""),
        price=MAX_FLOAT,
        reschedulable_pods=[],
    )


def build_candidates(
    kube,
    cluster: Cluster,
    cloud_provider,
    clock,
    should_disrupt: Callable[[Candidate], bool],
    disruption_class: str = "graceful",
) -> list[Candidate]:
    """GetCandidates with pods/prices resolved (the working entry point).

    disruption_class (types.go:47-48 + types.go:118): GRACEFUL methods
    (consolidation, emptiness) always respect blocking PDBs and the
    do-not-disrupt annotation; EVENTUAL methods (drift, static drift)
    on a claim with a TerminationGracePeriod may disrupt anyway — the TGP
    bounds how long those pods can hold the node."""
    nodepools = {np.name: np for np in kube.list("NodePool")}
    pdb_limits = PDBLimits.from_kube(kube)
    its_cache: dict[str, dict[str, object]] = {}
    now = clock.now()
    out: list[Candidate] = []
    for sn in cluster.state_nodes():
        c = _build_candidate(sn, nodepools, cloud_provider, pdb_limits, now)
        if c is None:
            continue
        pods = cluster.pods_on(sn.name)
        tgp_eventual = (
            disruption_class == "eventual"
            and sn.node_claim is not None
            and sn.node_claim.termination_grace_period_seconds is not None
        )
        # pods blocking disruption entirely (statenode.go:234): do-not-disrupt
        if not tgp_eventual and any(
            p.metadata.annotations.get(well_known.DO_NOT_DISRUPT_ANNOTATION_KEY)
            == "true"
            for p in pods
        ):
            continue
        # PDB check: every evictable pod must be currently evictable
        blocked = False
        if not tgp_eventual:
            for p in pods:
                ok, _ = pdb_limits.can_evict(p)
                if not ok or pdb_limits.is_fully_blocked(p) is not None:
                    blocked = True
                    break
        if blocked:
            continue
        c.reschedulable_pods = [p for p in pods if is_reschedulable(p)]
        # cost over ALL pods on the candidate, not just reschedulable ones
        # (types.go:131-132 — "we get the disruption cost from all pods")
        c.disruption_cost = disruption_cost(
            pods, clock, c.state_node.node_claim
        )
        c.price = _candidate_price(c, cloud_provider, its_cache)
        if should_disrupt(c):
            out.append(c)
    return out


def _candidate_price(c: Candidate, cloud_provider, its_cache) -> float:
    """consolidation.go:314 getCandidatePrices: the price of the candidate's
    current offering."""
    pool_types = its_cache.get(c.nodepool_name)
    if pool_types is None:
        pool_types = {
            it.name: it for it in cloud_provider.get_instance_types(c.node_pool)
        }
        its_cache[c.nodepool_name] = pool_types
    it = pool_types.get(c.instance_type_name)
    if it is None:
        return MAX_FLOAT
    reqs = Requirements.from_labels(
        {
            well_known.CAPACITY_TYPE_LABEL_KEY: c.capacity_type,
            well_known.TOPOLOGY_ZONE_LABEL_KEY: c.zone,
        }
    )
    for o in it.offerings:
        if o.available and o.requirements.is_compatible(reqs):
            return o.price
    return MAX_FLOAT


# ---------------------------------------------------------------------------
# budgets


@dataclass
class BudgetMapping:
    """helpers.go:231 BuildDisruptionBudgetMapping: per nodepool, how many
    more nodes may be disrupted right now for a given reason."""

    allowed: dict[str, int] = field(default_factory=dict)

    def can_disrupt(self, nodepool: str, n: int = 1) -> bool:
        return self.allowed.get(nodepool, 0) >= n

    def consume(self, nodepool: str, n: int = 1) -> None:
        self.allowed[nodepool] = max(0, self.allowed.get(nodepool, 0) - n)


def build_budget_mapping(kube, cluster: Cluster, reason: str) -> BudgetMapping:
    mapping = BudgetMapping()
    # count nodes per nodepool and nodes already being disrupted
    totals: dict[str, int] = {}
    disrupting: dict[str, int] = {}
    for sn in cluster.state_nodes():
        np_name = sn.nodepool_name
        if np_name is None:
            continue
        totals[np_name] = totals.get(np_name, 0) + 1
        if sn.marked_for_deletion or sn.deleting():
            disrupting[np_name] = disrupting.get(np_name, 0) + 1
    for np in kube.list("NodePool"):
        total = totals.get(np.name, 0)
        allowed = total  # no budgets = unlimited up to pool size
        for budget in np.disruption.budgets:
            if budget.reasons and reason not in budget.reasons:
                continue
            raw = budget.nodes.strip()
            if raw.endswith("%"):
                # nodepool.go:359 GetScaledValueFromIntOrPercent(roundUp=true):
                # a 10% budget on a 5-node pool still allows 1 disruption
                limit = math.ceil(total * float(raw[:-1]) / 100.0)
            else:
                limit = int(raw)
            allowed = min(allowed, limit)
        mapping.allowed[np.name] = max(0, allowed - disrupting.get(np.name, 0))
    return mapping
