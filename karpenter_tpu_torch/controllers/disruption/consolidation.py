"""Consolidation methods: Emptiness, Drift, MultiNode, SingleNode.

A copy of the reference's `controllers/disruption/consolidation.py`
(consolidation.go:53-332 the shared gates and the delete-versus-replace
decision, multinodeconsolidation.go:51-236, singlenodeconsolidation.go:
56-175, emptiness.go:31-115, drift.go:38-116).

Every method takes `device` (None = the card, "cpu" for the plain
versions) and hands it to the scheduling simulation
(`helpers.simulate_scheduling`, the kernels through TorchHybridScheduler)
and to the batched sweeps: K8 (`setsweep.sweep_sets`, the "sets" rung), K6
(`sweep.sweep_first_n`, the "batched" rung, and single-node consolidation's
singleton lanes) and K7 where the fast gates fail. It is resolved at
construction, so without a card the constructor raises; a `force_oracle`
method runs no device code and resolves none. `force_oracle` is the kill
switch that keeps the kernels out of every decision.

The strategy ladder (sets -> batched -> binary) falls a rung on
`SweepUnsupported` and on nothing else: a kernel that fails to build or
launch, or a card out of memory, raises out of `compute_commands`.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.cloudprovider.types import MAX_FLOAT
from karpenter_tpu_torch.controllers.disruption.helpers import (
    build_budget_mapping,
    build_candidates,
    simulate_scheduling,
)
from karpenter_tpu_torch.controllers.disruption.setsweep import sweep_sets
from karpenter_tpu_torch.controllers.disruption.sweep import (
    SweepUnsupported,
    singleton_feasibility,
    sweep_first_n,
)
from karpenter_tpu_torch.controllers.disruption.types import (
    REASON_DRIFTED,
    REASON_EMPTY,
    REASON_UNDERUTILIZED,
    Candidate,
    Command,
)
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.options import Options

# consolidation.go:49 MinInstanceTypesForSpotToSpotConsolidation
MIN_TYPES_FOR_SPOT_TO_SPOT = 15
# multinodeconsolidation.go:86 max candidates considered per pass
MAX_MULTI_NODE_CANDIDATES = 100


class ConsolidationBase:
    """consolidation.go:53 consolidation: shared gates + decision logic."""

    reason = REASON_UNDERUTILIZED

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
        self.force_oracle = force_oracle
        self.device = None if force_oracle else resolve_device(device)

    # -- gates ------------------------------------------------------------

    def should_disrupt(self, c: Candidate) -> bool:
        """consolidation.go:89 ShouldDisrupt: nodepool allows consolidation
        and the claim's Consolidatable condition is True."""
        if c.owned_by_static_nodepool():  # consolidation.go:91
            return False
        policy = c.node_pool.disruption.consolidation_policy
        if policy == "WhenEmpty" and not c.is_empty():
            return False
        return c.consolidatable()

    # graceful methods always respect blocking PDBs / do-not-disrupt;
    # eventual methods override (types.go:47-48)
    disruption_class = "graceful"

    def candidates(self) -> list[Candidate]:
        out = build_candidates(
            self.kube, self.cluster, self.cloud, self.clock,
            self.should_disrupt, disruption_class=self.disruption_class,
        )
        # consolidation.go:127 sortCandidates: cheapest disruption first
        out.sort(key=lambda c: (c.disruption_cost, c.name))
        return out

    def simulate(self, candidates: list[Candidate]):
        """helpers.simulate_scheduling of removing `candidates`, on this
        method's device (or the oracle alone under force_oracle)."""
        return simulate_scheduling(
            self.kube, self.cluster, self.cloud, candidates, self.opts,
            force_oracle=self.force_oracle, device=self.device,
        )

    # -- the decision ------------------------------------------------------

    def compute_consolidation(self, candidates: list[Candidate]) -> Command:
        """consolidation.go:137 computeConsolidation: simulate removal; all
        pods must land; delete if no new node needed, else replace with at
        most one strictly-cheaper node."""
        if not candidates:
            return Command(reason=self.reason)
        sim = self.simulate(candidates)
        if not sim.all_pods_scheduled():
            return Command(reason=self.reason)
        new_claims = sim.non_empty_new_claims()
        if not new_claims:
            return Command(reason=self.reason, candidates=list(candidates))
        if len(new_claims) > 1:
            # multi-node replacement is never a win (consolidation.go:184)
            return Command(reason=self.reason)

        claim = new_claims[0]
        current_price = sum(c.price for c in candidates)
        if current_price >= MAX_FLOAT:
            return Command(reason=self.reason)

        # the replacement must be strictly cheaper: filter its instance
        # types to those under the current total price
        # (consolidation.go:199 filterByPrice)
        cheaper = type(claim.instance_type_options)(
            it
            for it in claim.instance_type_options
            if it.offerings.available().cheapest_launch_price(claim.requirements)
            < current_price
        )
        if not cheaper:
            return Command(reason=self.reason)

        # spot-to-spot (consolidation.go:237): all-spot candidates replaced
        # by spot require >= 15 cheaper types (flexibility floor) unless the
        # feature gate is off, in which case skip entirely
        all_spot = all(
            c.capacity_type == well_known.CAPACITY_TYPE_SPOT for c in candidates
        )
        replacement_allows_spot = any(
            o.capacity_type() == well_known.CAPACITY_TYPE_SPOT
            for it in cheaper
            for o in it.offerings.available()
        )
        if all_spot and replacement_allows_spot:
            if not self.opts.feature_gates.spot_to_spot_consolidation:
                return Command(reason=self.reason)
            if len(candidates) == 1 and len(cheaper) < MIN_TYPES_FOR_SPOT_TO_SPOT:
                return Command(reason=self.reason)
            if len(candidates) == 1:
                # single spot->spot: restrict to the 15 cheapest types
                # (consolidation.go:291)
                ordered = cheaper.order_by_price(claim.requirements)
                cheaper = type(cheaper)(ordered[:MIN_TYPES_FOR_SPOT_TO_SPOT])

        claim.instance_type_options = cheaper
        return Command(
            reason=self.reason, candidates=list(candidates), replacements=[claim]
        )


class EmptinessConsolidation(ConsolidationBase):
    """emptiness.go:31 Emptiness: delete empty consolidatable nodes —
    no simulation needed."""

    reason = REASON_EMPTY

    def should_disrupt(self, c: Candidate) -> bool:
        if c.owned_by_static_nodepool():  # emptiness.go:43
            return False
        return c.is_empty() and c.consolidatable()

    def compute_commands(self) -> list[Command]:
        candidates = self.candidates()
        if not candidates:
            return []
        budgets = build_budget_mapping(self.kube, self.cluster, self.reason)
        allowed = []
        for c in candidates:
            if budgets.can_disrupt(c.nodepool_name):
                budgets.consume(c.nodepool_name)
                allowed.append(c)
        if not allowed:
            return []
        return [Command(reason=self.reason, candidates=allowed)]


class DriftConsolidation(ConsolidationBase):
    """drift.go:38 Drift: replace drifted nodes, budget-gated, one at a
    time in drift-condition order. Drift is an eventual disruption method
    (drift.go:111): a TerminationGracePeriod on the claim lets it proceed
    past do-not-disrupt pods and blocking PDBs."""

    reason = REASON_DRIFTED
    disruption_class = "eventual"

    def should_disrupt(self, c: Candidate) -> bool:
        return not c.owned_by_static_nodepool() and c.drifted()  # drift.go:56

    def compute_commands(self) -> list[Command]:
        candidates = self.candidates()
        budgets = build_budget_mapping(self.kube, self.cluster, self.reason)
        for c in candidates:
            if not budgets.can_disrupt(c.nodepool_name):
                continue
            if c.is_empty():
                return [Command(reason=self.reason, candidates=[c])]
            sim = self.simulate([c])
            if not sim.all_pods_scheduled():
                continue
            return [
                Command(
                    reason=self.reason,
                    candidates=[c],
                    replacements=sim.non_empty_new_claims(),
                )
            ]
        return []


class MultiNodeConsolidation(ConsolidationBase):
    """multinodeconsolidation.go:51: find the best removal set among the
    disruption-cost-sorted candidates replaceable by <= 1 new node.

    The strategy ladder, each rung falling to the next on SweepUnsupported:

      sets    — bounded search over arbitrary removal sets, one K8 launch
                per proposal round (setsweep.sweep_sets; it subsumes the
                prefix sweep and materializes the largest feasible prefix
                as a backstop)
      batched — every prefix in one launch (K6, or K7 where the fast gates
                fail; sweep.sweep_first_n)
      binary  — the reference's O(log N) bisection with a full simulation
                per probe (multinodeconsolidation.go:116)

    Every rung materializes its result through the same
    compute_consolidation, so prices, spot rules and replacements agree
    across rungs."""

    def __init__(self, *args, sweep: str = "sets", **kwargs):
        super().__init__(*args, **kwargs)
        # sweep is env-overridable (KARPENTER_MULTINODE_SWEEP_STRATEGY);
        # fail fast with the valid rungs
        if sweep not in ("sets", "batched", "binary"):
            raise ValueError(
                f"unknown multi-node sweep strategy {sweep!r}; "
                "expected one of: sets, batched, binary"
            )
        self.sweep = sweep

    def compute_commands(self) -> list[Command]:
        candidates = self.candidates()
        if not candidates:
            return []
        budgets = build_budget_mapping(self.kube, self.cluster, self.reason)
        # budget-trim the prefix per nodepool (controller enforces globally;
        # trimming here keeps the search honest)
        trimmed: list[Candidate] = []
        counts: dict[str, int] = {}
        for c in candidates[:MAX_MULTI_NODE_CANDIDATES]:
            n = counts.get(c.nodepool_name, 0)
            if budgets.can_disrupt(c.nodepool_name, n + 1):
                counts[c.nodepool_name] = n + 1
                trimmed.append(c)
        if not trimmed:
            return []
        search = {
            "sets": self.first_n_sets,
            "batched": self.first_n_batched,
            "binary": self.first_n_binary,
        }[self.sweep]
        cmd = search(trimmed)
        return [cmd] if cmd.candidates else []

    # -- search strategies -------------------------------------------------

    def first_n_binary(self, candidates: list[Candidate]) -> Command:
        """multinodeconsolidation.go:116 firstNConsolidationOption: binary
        search over the prefix length (the reference's sequential method)."""
        lo, hi = 1, len(candidates)
        best = Command(reason=self.reason)
        deadline = (
            self.clock.now() + self.opts.multinode_consolidation_timeout_seconds
        )
        while lo <= hi:
            if self.clock.now() > deadline:
                break
            mid = (lo + hi) // 2
            cmd = self.compute_consolidation(candidates[:mid])
            if cmd.candidates:
                best = cmd
                lo = mid + 1
            else:
                hi = mid - 1
        return best

    def first_n_batched(self, candidates: list[Candidate]) -> Command:
        """One launch evaluates the feasibility of every candidate prefix,
        then compute_consolidation materializes the command for the largest
        feasible prefix. Shapes the sweep can't express fall back to
        first_n_binary, the O(log N) bisection."""
        if not self.force_oracle:
            try:
                return sweep_first_n(self, candidates)
            except SweepUnsupported:
                pass
        return self.first_n_binary(candidates)

    def first_n_sets(self, candidates: list[Candidate]) -> Command:
        """Bounded search over arbitrary removal sets (setsweep.sweep_sets).
        Shapes the set kernel can't express fall to the prefix rungs."""
        if not self.force_oracle:
            try:
                return sweep_sets(self, candidates)
            except SweepUnsupported:
                pass
        return self.first_n_batched(candidates)


class SingleNodeConsolidation(ConsolidationBase):
    """singlenodeconsolidation.go:56: per-candidate simulation, nodepool
    round-robin ordering so one big pool can't starve the others.

    With sweep="batched" (the default) one launch (K6's singleton lanes)
    computes every candidate's removal feasibility; the sequential walk
    then runs the full simulation only on candidates whose lane came back
    feasible (an infeasible lane can only ever produce a no-op command, so
    skipping it is exact). Shapes the sweep can't express fall back to the
    reference's sequential walk."""

    def __init__(self, *args, sweep: str = "batched", **kwargs):
        super().__init__(*args, **kwargs)
        self.sweep = sweep

    def compute_commands(self) -> list[Command]:
        candidates = self.candidates()
        budgets = build_budget_mapping(self.kube, self.cluster, self.reason)
        # round-robin across nodepools (singlenodeconsolidation.go:139)
        by_pool: dict[str, list[Candidate]] = {}
        for c in candidates:
            by_pool.setdefault(c.nodepool_name, []).append(c)
        ordered: list[Candidate] = []
        pools = sorted(by_pool)
        i = 0
        while any(by_pool.values()):
            pool = pools[i % len(pools)]
            if by_pool[pool]:
                ordered.append(by_pool[pool].pop(0))
            i += 1
        feasible = None
        # force_oracle is the kernel kill switch: the sweep never drives
        # skip decisions for an oracle-forced controller
        if self.sweep == "batched" and not self.force_oracle and len(ordered) > 1:
            try:
                feasible = singleton_feasibility(
                    self.kube, self.cluster, self.cloud, ordered, self.opts,
                    device=self.device,
                )
            except SweepUnsupported:
                feasible = None
        # single-node gets its own budget: the reference walks candidates
        # for up to 3 minutes (singlenodeconsolidation.go:31), three times
        # the multi-node bisection's (multinodeconsolidation.go:35)
        deadline = (
            self.clock.now()
            + self.opts.singlenode_consolidation_timeout_seconds
        )
        for j, c in enumerate(ordered):
            if self.clock.now() > deadline:
                break
            if not budgets.can_disrupt(c.nodepool_name):
                continue
            if feasible is not None and not feasible[j]:
                continue  # lane says removal can't reschedule: no-op anyway
            cmd = self.compute_consolidation([c])
            if cmd.candidates:
                return [cmd]
        return []
