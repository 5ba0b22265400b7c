"""NodeClaim lifecycle: Launch -> Registration -> Initialization + Liveness,
plus the claim termination finalizer.

Reference pkg/controllers/nodeclaim/lifecycle/:
- launch.go:45-124 (CloudProvider.Create, Launched condition)
- registration.go:50-127 (node joins; sync labels/taints; Registered)
- initialization.go:46-134 (startup taints gone, resources present; Initialized)
- liveness.go:51-75 (TTL deletes for stuck claims)
- controller.go:184-273 (termination finalizer: delete instance + node)
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
    Operator,
)
from karpenter_tpu_torch.cloudprovider.types import CreateError, NodeClaimNotFoundError
from karpenter_tpu_torch.controllers.kube import Conflict, NotFound, SimKube
from karpenter_tpu_torch.controllers.state import UNREGISTERED_TAINT, Cluster
from karpenter_tpu_torch.events import Event, Recorder
from karpenter_tpu_torch.options import Options
from karpenter_tpu_torch import logging, metrics

TERMINATION_FINALIZER = well_known.TERMINATION_FINALIZER

LAUNCH_FAILURES = metrics.REGISTRY.counter(
    "karpenter_nodeclaims_launch_failed_total",
    "NodeClaim launch attempts that failed.",
    ("nodepool", "reason"),
)
CLAIMS_TERMINATED = metrics.REGISTRY.counter(
    "karpenter_nodeclaims_terminated_total",
    "NodeClaims terminated.",
    ("nodepool",),
)


class NodeClaimLifecycle:
    """One reconciler driving the whole claim state machine (the reference
    splits it into sub-reconcilers invoked in order; the order here is the
    same)."""

    def __init__(
        self,
        kube: SimKube,
        cluster: Cluster,
        cloud_provider,
        clock,
        options: Optional[Options] = None,
        recorder: Optional[Recorder] = None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud_provider
        self.clock = clock
        self.opts = options or Options()
        self.recorder = recorder or Recorder(clock)
        # claim name -> first-seen time, for liveness TTLs with FakeClock
        self._first_seen: dict[str, float] = {}
        # optional hook: nodepool registration-health ring buffer
        self.registration_health = None
        self.log = logging.root.named("nodeclaim.lifecycle")

    def reconcile_all(self) -> None:
        for claim in self.kube.list("NodeClaim"):
            self.reconcile(claim.name)

    def reconcile(self, name: str) -> Optional[str]:
        claim = self.kube.try_get("NodeClaim", name)
        if claim is None:
            self._first_seen.pop(name, None)
            return None
        if claim.metadata.deletion_timestamp is not None:
            return self._terminate(claim)
        if TERMINATION_FINALIZER not in claim.metadata.finalizers:
            claim.metadata.finalizers.append(TERMINATION_FINALIZER)
            claim = self._update(claim)
            if claim is None:
                return None
        self._first_seen.setdefault(name, self.clock.now())

        if claim.status.conditions.get(COND_LAUNCHED) != "True":
            return self._launch(claim)
        if claim.status.conditions.get(COND_REGISTERED) != "True":
            return self._register(claim)
        if claim.status.conditions.get(COND_INITIALIZED) != "True":
            return self._initialize(claim)
        return None

    # -- phases -----------------------------------------------------------

    def _launch(self, claim: NodeClaim) -> Optional[str]:
        try:
            launched = self.cloud.create(claim)
        except CreateError as e:
            nodepool = claim.nodepool_name or ""
            LAUNCH_FAILURES.inc({"nodepool": nodepool, "reason": e.reason})
            self.recorder.publish(
                Event("NodeClaim", claim.name, "Warning", "LaunchFailed", str(e))
            )
            return self._liveness(claim)
        claim.status.provider_id = launched.status.provider_id
        claim.status.node_name = launched.status.node_name
        claim.status.capacity = dict(launched.status.capacity)
        claim.status.allocatable = dict(launched.status.allocatable)
        claim.status.image_id = launched.status.image_id
        # PopulateNodeClaimDetails (launch.go:126-140): cloud-resolved
        # labels, then single-value requirement labels, then user-defined
        # labels — later sources win. RequirementsDrifted diffs these
        # labels against the nodepool's requirements (drift.go:168-174).
        merged = dict(launched.metadata.labels)
        for r in claim.requirements:
            if r.operator == Operator.IN and len(r.values) == 1:
                merged[r.key] = r.values[0]
        merged.update(claim.metadata.labels)
        claim.metadata.labels = merged
        claim.status.conditions[COND_LAUNCHED] = "True"
        self._update(claim)
        self.log.info(
            "launched nodeclaim",
            nodeclaim=claim.name,
            provider_id=claim.status.provider_id,
        )
        return "launched"

    def _register(self, claim: NodeClaim) -> Optional[str]:
        node = self._node_for(claim)
        if node is None:
            return self._liveness(claim)
        # sync: claim labels/annotations flow to the node; the unregistered
        # taint is removed exactly once (registration.go:50-127)
        changed = False
        for k, v in claim.metadata.labels.items():
            if node.metadata.labels.get(k) != v:
                node.metadata.labels[k] = v
                changed = True
        if UNREGISTERED_TAINT in node.taints:
            node.taints = [t for t in node.taints if t != UNREGISTERED_TAINT]
            changed = True
        if node.metadata.labels.get(well_known.NODE_REGISTERED_LABEL_KEY) != "true":
            node.metadata.labels[well_known.NODE_REGISTERED_LABEL_KEY] = "true"
            changed = True
        if changed:
            try:
                self.kube.update("Node", node)
            except (Conflict, NotFound):
                return None  # requeue
        claim.status.node_name = node.name
        claim.status.conditions[COND_REGISTERED] = "True"
        self._update(claim)
        # a successful registration feeds the nodepool health ring
        # (registration.go:113-123: dry-run flip, then commit)
        if self.registration_health is not None:
            self.registration_health.record_launch(claim.nodepool_name or "", True)
        self.recorder.publish(
            Event("NodeClaim", claim.name, "Normal", "Registered", node.name)
        )
        return "registered"

    def _initialize(self, claim: NodeClaim) -> Optional[str]:
        node = self._node_for(claim)
        if node is None:
            return None
        if not node.ready:
            return None
        # startup AND known-ephemeral taints must have been removed
        # (initialization.go:46 StartupTaintsRemoved + :88
        # KnownEphemeralTaintsRemoved — a not-ready/unreachable node is
        # not initialized no matter how ready its kubelet claims to be)
        from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS

        blocked = {
            (t.key, t.effect)
            for t in list(claim.startup_taints) + list(KNOWN_EPHEMERAL_TAINTS)
        }
        if any((t.key, t.effect) in blocked for t in node.taints):
            return None
        # resources registered
        if not node.allocatable:
            return None
        node.metadata.labels[well_known.NODE_INITIALIZED_LABEL_KEY] = "true"
        try:
            self.kube.update("Node", node)
        except (Conflict, NotFound):
            return None
        claim.status.conditions[COND_INITIALIZED] = "True"
        self._update(claim)
        return "initialized"

    def _liveness(self, claim: NodeClaim) -> Optional[str]:
        """liveness.go:51: delete claims stuck before registration."""
        first = self._first_seen.get(claim.name, self.clock.now())
        age = self.clock.now() - first
        launched = claim.status.conditions.get(COND_LAUNCHED) == "True"
        if not launched and age > self.opts.launch_ttl_seconds:
            self.log.warn(
                "liveness TTL exceeded before launch; deleting nodeclaim",
                nodeclaim=claim.name, age_seconds=round(age, 1),
            )
            # a claim that never made it feeds the health ring as a failure
            # (liveness.go:89 + 156: dry-run flip, then commit)
            if self.registration_health is not None:
                self.registration_health.record_launch(
                    claim.nodepool_name or "", False
                )
            self.kube.delete("NodeClaim", claim.name)
            self.recorder.publish(
                Event(
                    "NodeClaim", claim.name, "Warning", "LivenessTimeout",
                    f"not launched after {age:.0f}s",
                )
            )
            return "liveness-deleted"
        if launched and age > self.opts.registration_ttl_seconds:
            self.log.warn(
                "liveness TTL exceeded before registration; deleting nodeclaim",
                nodeclaim=claim.name, age_seconds=round(age, 1),
            )
            if self.registration_health is not None:
                self.registration_health.record_launch(
                    claim.nodepool_name or "", False
                )
            self.kube.delete("NodeClaim", claim.name)
            self.recorder.publish(
                Event(
                    "NodeClaim", claim.name, "Warning", "LivenessTimeout",
                    f"not registered after {age:.0f}s",
                )
            )
            return "liveness-deleted"
        return None

    # -- termination finalizer (controller.go:184) ------------------------

    def _terminate(self, claim: NodeClaim) -> Optional[str]:
        # delete the node first; its own termination finalizer drains it
        node = self._node_for(claim)
        if node is not None and node.metadata.deletion_timestamp is None:
            self.kube.delete("Node", node.name)
            return "awaiting-node-termination"
        if node is not None:
            return "awaiting-node-termination"
        try:
            self.cloud.delete(claim)
        except NodeClaimNotFoundError:
            pass
        if TERMINATION_FINALIZER in claim.metadata.finalizers:
            claim.metadata.finalizers.remove(TERMINATION_FINALIZER)
            try:
                self.kube.update("NodeClaim", claim)
            except (Conflict, NotFound):
                return None
        CLAIMS_TERMINATED.inc({"nodepool": claim.nodepool_name or ""})
        self._first_seen.pop(claim.name, None)
        return "terminated"

    # -- helpers ----------------------------------------------------------

    def _node_for(self, claim: NodeClaim):
        # the cluster cache indexes provider ids; avoid a deep-copy List scan
        sn = self.cluster.node_by_claim_name(claim.name)
        if sn is not None and sn.node is not None:
            return self.kube.try_get("Node", sn.node.name)
        if claim.status.node_name:
            return self.kube.try_get("Node", claim.status.node_name)
        return None

    def _update(self, claim: NodeClaim) -> Optional[NodeClaim]:
        try:
            return self.kube.update("NodeClaim", claim)
        except (Conflict, NotFound):
            return None
