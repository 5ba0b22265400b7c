"""Disruption validation and orchestration.

A copy of the reference's `controllers/disruption/queue.py`
(validation.go:52-316: re-check a command after a TTL so pod churn between
decision and execution can veto it; queue.go:94-412: taint -> launch
replacements -> wait for readiness -> delete originals, rolling back on
unrecoverable errors).

The Validator re-simulates through `helpers.simulate_scheduling` on its
`device` (None = the card, "cpu" for the plain versions; resolved at
construction unless `force_oracle`). Replacements launch through the
port's `Provisioner.create_node_claims`. The queue waits for each
replacement NodeClaim's Initialized condition, which the lifecycle
controller (`controllers/lifecycle.py`) sets once the node initializes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api.objects import COND_INITIALIZED
from karpenter_tpu_torch.api.objects import NodeClaim as ApiNodeClaim
from karpenter_tpu_torch.controllers.disruption.helpers import simulate_scheduling
from karpenter_tpu_torch.controllers.disruption.types import DECISION_DELETE, Command
from karpenter_tpu_torch.controllers.kube import Conflict, NotFound
from karpenter_tpu_torch.controllers.state import DISRUPTED_TAINT, is_reschedulable
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.events import Event
from karpenter_tpu_torch.solver.oracle import Results

# validation.go:46 consolidation TTL
VALIDATION_TTL_SECONDS = 15.0

COMMANDS_EXECUTED = metrics.REGISTRY.counter(
    "karpenter_disruption_commands_total",
    "Disruption commands by decision and reason.",
    ("decision", "reason"),
)
NODES_DISRUPTED = metrics.REGISTRY.counter(
    "karpenter_nodes_disrupted_total",
    "Nodes disrupted, by reason.",
    ("nodepool", "reason"),
)


class Validator:
    """validation.go:52: after the TTL, the candidates must still be
    disruptable and the consolidation decision must still hold."""

    def __init__(self, kube, cluster, cloud, clock, options, force_oracle=False, device=None):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud
        self.clock = clock
        self.opts = options
        self.force_oracle = force_oracle
        self.device = None if force_oracle else resolve_device(device)

    def validate(self, cmd: Command) -> bool:
        for c in cmd.candidates:
            sn = self.cluster.node_by_name(c.name)
            if sn is None or sn.deleting() or sn.marked_for_deletion:
                return False
            if sn.nominated(self.clock.now()):
                return False  # the provisioner wants this node
        if all(c.owned_by_static_nodepool() for c in cmd.candidates):
            # StaticDrift is an eventual-class method: its replacement is a
            # workload-independent template launch, so the consolidation
            # re-simulation (which excludes static pools) must not veto it;
            # the reference never validates it (controller.go dispatches
            # validation per method class)
            return True
        if cmd.decision == DECISION_DELETE and all(
            c.is_empty() for c in cmd.candidates
        ):
            # emptiness validation: still empty of *reschedulable* pods
            # (emptiness.go:67 — daemonsets/terminal pods don't count)
            for c in cmd.candidates:
                if any(
                    is_reschedulable(p) for p in self.cluster.pods_on(c.name)
                ):
                    return False
            return True
        # consolidation validation: re-simulate (validation.go:152)
        sim = simulate_scheduling(
            self.kube,
            self.cluster,
            self.cloud,
            cmd.candidates,
            self.opts,
            force_oracle=self.force_oracle,
            device=self.device,
        )
        if not sim.all_pods_scheduled():
            return False
        new_claims = sim.non_empty_new_claims()
        if cmd.decision == DECISION_DELETE:
            return not new_claims
        return len(new_claims) <= len(cmd.replacements)


@dataclass
class _InFlight:
    command: Command
    replacement_names: list[str] = field(default_factory=list)
    launched: bool = False


class OrchestrationQueue:
    """queue.go:94: executes validated commands. Because SimKube is
    synchronous, the retry machinery reduces to: taint+mark, create
    replacement claims, then on every reconcile check replacement readiness
    and finally delete the originals (rollback if a replacement failed)."""

    def __init__(self, kube, cluster, provisioner, clock, recorder):
        self.kube = kube
        self.cluster = cluster
        self.provisioner = provisioner
        self.clock = clock
        self.recorder = recorder
        self.in_flight: list[_InFlight] = []

    def start_command(self, cmd: Command) -> None:
        """queue.go:306 StartCommand: taint + MarkForDeletion + launch
        replacements."""
        names = [c.name for c in cmd.candidates]
        self.cluster.mark_for_deletion(*names)
        # queue.go:279: static candidates become pending-disruption (their
        # replacement is being created; StaticProvisioning must not race)
        for c in cmd.candidates:
            claim_name = c.claim_name()
            if c.owned_by_static_nodepool() and claim_name is not None:
                self.cluster.nodepool_state.mark_pending_disruption(
                    c.nodepool_name, claim_name
                )
        for c in cmd.candidates:
            node = self.kube.try_get("Node", c.name)
            if node is not None and DISRUPTED_TAINT not in node.taints:
                node.taints = list(node.taints) + [DISRUPTED_TAINT]
                try:
                    self.kube.update("Node", node)
                except (Conflict, NotFound):
                    pass
        item = _InFlight(command=cmd)
        if cmd.replacements:
            bare = [r for r in cmd.replacements if isinstance(r, ApiNodeClaim)]
            solved = [r for r in cmd.replacements if not isinstance(r, ApiNodeClaim)]
            # StaticDrift replacements are bare template launches with no
            # pods (staticdrift.go:95) — create them directly and convert
            # their node-count reservation (provisioner.go:166)
            for nc in bare:
                stored = self.kube.create("NodeClaim", nc)
                item.replacement_names.append(stored.name)
                pool = stored.nodepool_name
                if pool:
                    # launch converts the reservation to an active claim
                    self.cluster.nodepool_state.release_node_count(pool, 1)
                    cmd.reserved_count = max(0, cmd.reserved_count - 1)
            if solved:
                fake_results = Results(
                    new_node_claims=solved,
                    existing_nodes=[],
                    pod_errors={},
                )
                created = self.provisioner.create_node_claims(fake_results)
                item.replacement_names += [c.name for c in created]
        item.launched = True
        self.in_flight.append(item)
        COMMANDS_EXECUTED.inc(
            {"decision": cmd.decision, "reason": cmd.reason}
        )
        for c in cmd.candidates:
            NODES_DISRUPTED.inc(
                {"nodepool": c.nodepool_name, "reason": cmd.reason}
            )
            self.recorder.publish(
                Event(
                    "Node", c.name, "Normal", "DisruptionTerminating",
                    f"disrupting via {cmd.reason} ({cmd.decision})",
                )
            )

    def reconcile(self) -> None:
        """queue.go:137: for each in-flight command, wait for replacements
        to initialize, then delete the originals."""
        remaining: list[_InFlight] = []
        for item in self.in_flight:
            done, failed = self._replacements_state(item)
            if failed:
                # rollback (queue.go:181 waitOrTerminate unrecoverable)
                self.cluster.unmark_for_deletion(
                    *[c.name for c in item.command.candidates]
                )
                for c in item.command.candidates:
                    node = self.kube.try_get("Node", c.name)
                    if node is not None and DISRUPTED_TAINT in node.taints:
                        node.taints = [
                            t for t in node.taints if t != DISRUPTED_TAINT
                        ]
                        try:
                            self.kube.update("Node", node)
                        except (Conflict, NotFound):
                            pass
                continue
            if not done:
                remaining.append(item)
                continue
            for c in item.command.candidates:
                claim_name = c.claim_name()
                try:
                    if claim_name is not None:
                        self.kube.delete("NodeClaim", claim_name)
                    else:
                        self.kube.delete("Node", c.name)
                except NotFound:
                    pass
        self.in_flight = remaining

    def _replacements_state(self, item: _InFlight) -> tuple[bool, bool]:
        """(all ready, any failed)"""
        if not item.replacement_names:
            return True, False
        ready = 0
        for name in item.replacement_names:
            claim = self.kube.try_get("NodeClaim", name)
            if claim is None:
                return False, True  # liveness deleted it -> roll back
            if claim.status.conditions.get(COND_INITIALIZED) == "True":
                ready += 1
        return ready == len(item.replacement_names), False

    @property
    def busy(self) -> bool:
        return bool(self.in_flight)
