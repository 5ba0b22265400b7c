"""The disruption controller: the 10s singleton loop trying methods in
order — Emptiness, StaticDrift, Drift, MultiNodeConsolidation,
SingleNodeConsolidation — first success wins.

A copy of the reference's `controllers/disruption/controller.py`
(controller.go:69-227). `device` (None = the card, "cpu" for the plain
versions) goes to every method and to the Validator; `force_oracle` keeps
the kernels out of every decision. A failure of the card inside a sweep or
a simulation propagates out of `reconcile`.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch import logging, metrics
from karpenter_tpu_torch.controllers.disruption.consolidation import (
    DriftConsolidation,
    EmptinessConsolidation,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_tpu_torch.controllers.disruption.queue import (
    VALIDATION_TTL_SECONDS,
    OrchestrationQueue,
    Validator,
)
from karpenter_tpu_torch.controllers.disruption.staticdrift import StaticDrift
from karpenter_tpu_torch.controllers.disruption.types import Command
from karpenter_tpu_torch.controllers.kube import Conflict, NotFound
from karpenter_tpu_torch.controllers.state import DISRUPTED_TAINT
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.options import Options

EVAL_DURATION = metrics.REGISTRY.histogram(
    "karpenter_disruption_evaluation_duration_seconds",
    "Duration of disruption evaluation loops.",
    ("method",),
)


class DisruptionController:
    def __init__(
        self,
        kube,
        cluster,
        cloud_provider,
        provisioner,
        clock,
        options: Optional[Options] = None,
        recorder: Optional[Recorder] = None,
        force_oracle: bool = False,
        validation_ttl_seconds: float = VALIDATION_TTL_SECONDS,
        device=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud_provider
        self.clock = clock
        self.opts = options or Options()
        self.recorder = recorder or Recorder(clock)
        self.queue = OrchestrationQueue(
            kube, cluster, provisioner, clock, self.recorder
        )
        args = (kube, cluster, cloud_provider, clock)
        kwargs = dict(
            options=self.opts, recorder=self.recorder, force_oracle=force_oracle,
            device=device,
        )
        # NewMethods order (controller.go:98); the multi-node search
        # enters the strategy ladder at the configured rung (sets ->
        # batched prefixes -> binary) and falls down it on SweepUnsupported
        self.methods = [
            EmptinessConsolidation(*args, **kwargs),
            StaticDrift(*args, **kwargs),
            DriftConsolidation(*args, **kwargs),
            MultiNodeConsolidation(
                *args, sweep=self.opts.multinode_sweep_strategy, **kwargs
            ),
            SingleNodeConsolidation(*args, **kwargs),
        ]
        self.validator = Validator(
            kube, cluster, cloud_provider, clock, self.opts, force_oracle, device=device
        )
        self.validation_ttl = validation_ttl_seconds
        self._pending_validation: Optional[tuple[float, Command]] = None
        self._last_run = -1e18
        self.log = logging.root.named("disruption")

    def reconcile(self) -> Optional[Command]:
        """One loop iteration (controller.go:121). Returns the command that
        started executing, if any."""
        now = self.clock.now()
        self.queue.reconcile()
        # a command awaiting its validation TTL?
        if self._pending_validation is not None:
            decided_at, cmd = self._pending_validation
            if now - decided_at < self.validation_ttl:
                return None
            self._pending_validation = None
            if self.validator.validate(cmd):
                self.log.info(
                    "executing disruption command",
                    reason=cmd.reason,
                    decision=cmd.decision,
                    candidates=len(cmd.candidates),
                    replacements=len(cmd.replacements),
                )
                self.queue.start_command(cmd)
                return cmd
            self.log.info(
                "disruption command failed validation",
                reason=cmd.reason,
                candidates=len(cmd.candidates),
            )
            self._release_reservation(cmd)
            return None
        if now - self._last_run < self.opts.disruption_poll_seconds:
            return None
        self._last_run = now
        if not self.cluster.synced(self.kube):
            return None
        if self.queue.busy:
            return None  # one command at a time (the reference serializes
            # via candidate taints; a single queue keeps it simple)
        self._clean_stale_taints()
        for method in self.methods:
            label = type(method).__name__
            with EVAL_DURATION.measure({"method": label}):
                commands = method.compute_commands()
            if not commands:
                continue
            cmd = commands[0]
            # this controller serializes one command at a time; any node-
            # count reservations held by the commands it won't execute must
            # be handed back (the next reconcile re-reserves)
            for other in commands[1:]:
                self._release_reservation(other)
            self.log.debug(
                "disruption command proposed",
                method=label,
                reason=cmd.reason,
                decision=cmd.decision,
                candidates=len(cmd.candidates),
            )
            self._pending_validation = (now, cmd)
            return None
        # nothing to do: the cluster is consolidated (cluster.go:550)
        self.cluster.mark_consolidated()
        return None

    def _release_reservation(self, cmd: Command) -> None:
        if cmd.reserved_pool and cmd.reserved_count > 0:
            self.cluster.nodepool_state.release_node_count(
                cmd.reserved_pool, cmd.reserved_count
            )
            cmd.reserved_count = 0

    def _clean_stale_taints(self) -> None:
        """controller.go:143: nodes tainted for disruption but no longer
        part of any in-flight command get un-tainted."""
        in_flight_names = {
            c.name
            for item in self.queue.in_flight
            for c in item.command.candidates
        }
        pending = (
            {c.name for c in self._pending_validation[1].candidates}
            if self._pending_validation is not None
            else set()
        )
        keep = in_flight_names | pending
        for node in self.kube.list("Node"):
            if node.name in keep or DISRUPTED_TAINT not in node.taints:
                continue
            sn = self.cluster.node_by_name(node.name)
            if sn is not None and (sn.deleting() or sn.marked_for_deletion):
                continue
            node.taints = [t for t in node.taints if t != DISRUPTED_TAINT]
            try:
                self.kube.update("Node", node)
            except (Conflict, NotFound):
                pass
