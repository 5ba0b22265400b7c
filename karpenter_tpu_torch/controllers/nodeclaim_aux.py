"""NodeClaim auxiliary controllers: disruption conditions, expiration,
garbage collection, pod events, consistency, hydration.

Reference pkg/controllers/nodeclaim/:
- disruption/consolidation.go:38 (Consolidatable after consolidateAfter of
  pod-event quiet), disruption/drift.go:50-183 (Drifted via provider +
  nodepool hash)
- expiration/controller.go:57-97 (expireAfter deletes)
- garbagecollection/controller.go:60-119 (cloud<->cluster reconciliation)
- podevents/controller.go:63-99 (lastPodEventTime stamping)
- consistency/controller.go:79-150 (invariant checks)
- hydration/controller.go:56-77 (field backfill)
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    COND_CONSISTENT_STATE_FOUND,
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    COND_EMPTY,
    COND_INITIALIZED,
    NodeClaim,
    NodePool,
    PodPhase,
)
from karpenter_tpu_torch.controllers.kube import DELETED, Conflict, NotFound, SimKube
from karpenter_tpu_torch.controllers.state import Cluster, is_reschedulable
from karpenter_tpu_torch.events import Event, Recorder
from karpenter_tpu_torch import metrics

NODEPOOL_HASH_VERSION = "v1"

CLAIMS_EXPIRED = metrics.REGISTRY.counter(
    "karpenter_nodeclaims_expired_total", "NodeClaims deleted by expiration.", ("nodepool",)
)
CLAIMS_GARBAGE_COLLECTED = metrics.REGISTRY.counter(
    "karpenter_nodeclaims_garbage_collected_total",
    "NodeClaims or instances removed by garbage collection.",
    ("direction",),
)


def nodepool_hash(np: NodePool) -> str:
    """Static-field drift hash (reference nodepool.go Hash): the fields of
    the template that force replacement when changed."""
    spec = np.template
    payload = {
        "labels": dict(sorted(spec.labels.items())),
        "annotations": dict(sorted(spec.annotations.items())),
        "taints": sorted(
            (t.key, t.value, str(t.effect)) for t in spec.taints
        ),
        "startup_taints": sorted(
            (t.key, t.value, str(t.effect)) for t in spec.startup_taints
        ),
        "node_class_ref": spec.node_class_ref,
        "expire_after": spec.expire_after_seconds,
        "tgp": spec.termination_grace_period_seconds,
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


class NodeClaimDisruptionConditions:
    """nodeclaim/disruption: stamps Consolidatable / Drifted / Empty."""

    def __init__(self, kube: SimKube, cluster: Cluster, cloud, clock):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud
        self.clock = clock

    def reconcile_all(self) -> None:
        nodepools = {np.name: np for np in self.kube.list("NodePool")}
        for claim in self.kube.list("NodeClaim"):
            self.reconcile(claim, nodepools)

    def reconcile(self, claim: NodeClaim, nodepools: dict) -> None:
        if claim.metadata.deletion_timestamp is not None:
            return
        np = nodepools.get(claim.nodepool_name)
        if np is None:
            return
        changed = False
        changed |= self._consolidatable(claim, np)
        changed |= self._drifted(claim, np)
        changed |= self._empty(claim)
        if changed:
            try:
                self.kube.update("NodeClaim", claim)
            except (Conflict, NotFound):
                pass

    def _consolidatable(self, claim: NodeClaim, np: NodePool) -> bool:
        """consolidation.go:38: quiet (no pod events) for consolidateAfter."""
        if claim.status.conditions.get(COND_INITIALIZED) != "True":
            return False
        quiet_since = claim.status.last_pod_event_time or claim.metadata.creation_timestamp
        consolidatable = (
            self.clock.now() - quiet_since
            >= np.disruption.consolidate_after_seconds
        )
        want = "True" if consolidatable else "False"
        if claim.status.conditions.get(COND_CONSOLIDATABLE) != want:
            claim.status.conditions[COND_CONSOLIDATABLE] = want
            return True
        return False

    def _drifted(self, claim: NodeClaim, np: NodePool) -> bool:
        """drift.go:50 isDrifted: static-field hash drift, then
        requirements drift, then the provider verdict (cheap checks first,
        matching the reference's ordering to save provider calls)."""
        drifted = ""
        claim_hash = claim.metadata.annotations.get(
            well_known.NODEPOOL_HASH_ANNOTATION_KEY
        )
        claim_ver = claim.metadata.annotations.get(
            well_known.NODEPOOL_HASH_VERSION_ANNOTATION_KEY
        )
        if (
            claim_hash is not None
            and claim_ver == NODEPOOL_HASH_VERSION
            and claim_hash != nodepool_hash(np)
        ):
            drifted = "NodePoolDrifted"
        if not drifted:
            drifted = self._requirements_drifted(claim, np)
        if not drifted:
            drifted = self.cloud.is_drifted(claim) or ""
        want = "True" if drifted else "False"
        if claim.status.conditions.get(COND_DRIFTED) != want:
            claim.status.conditions[COND_DRIFTED] = want
            return True
        return False

    @staticmethod
    def _requirements_drifted(claim: NodeClaim, np: NodePool) -> str:
        """drift.go:168-174 areRequirementsDrifted: every nodepool template
        requirement must be compatible with the claim's label set (the
        labels PopulateNodeClaimDetails resolved at launch) — a nodepool
        whose requirements changed out from under its nodes drifts them."""
        from karpenter_tpu_torch.scheduling import Requirements

        if not claim.metadata.labels:
            return ""  # not yet populated (pre-launch) — nothing to diff
        pool_reqs = Requirements.from_node_selector_requirements(
            np.template.requirements
        )
        claim_reqs = Requirements.from_labels(claim.metadata.labels)
        if claim_reqs.compatible(pool_reqs) is not None:
            return "RequirementsDrifted"
        return ""

    def _empty(self, claim: NodeClaim) -> bool:
        if claim.status.conditions.get(COND_INITIALIZED) != "True":
            return False
        node_name = claim.status.node_name
        pods = [
            p
            for p in self.cluster.pods_on(node_name)
            if is_reschedulable(p)
        ] if node_name else []
        want = "True" if not pods else "False"
        if claim.status.conditions.get(COND_EMPTY) != want:
            claim.status.conditions[COND_EMPTY] = want
            return True
        return False


class PodEvents:
    """nodeclaim/podevents: stamp lastPodEventTime on REAL pod events for
    the claim's node (podevents/controller.go:63-99 + the Register event
    filter at controller.go:104): a pod newly BOUND to the node, newly
    TERMINAL (Succeeded/Failed), or newly TERMINATING (deletionTimestamp
    set). Event-driven off the SimKube watch (round 5) — the former
    count-delta heuristic went quiet under equal-count churn (one pod
    leaves while another binds between reconcile ticks), wrongly letting
    Consolidatable fire on a busy node. A finalizer-less sim delete skips
    the terminating transition, so a DELETED event with a node name stamps
    too (it IS that transition, compressed). Daemonset-owned pods are
    ignored (controller.go:66) and stamps dedupe per claim within 10s
    (dedupeTimeout, controller.go:41-44)."""

    DEDUPE_SECONDS = 10.0

    def __init__(self, kube: SimKube, cluster: Cluster, clock):
        self.kube = kube
        self.cluster = cluster
        self.clock = clock
        # pod uid -> (node_name, terminal, terminating): the "old object"
        # a controller-runtime UpdateFunc sees; SimKube watches carry only
        # the new state
        self._seen: dict[str, tuple[str, bool, bool]] = {}
        kube.subscribe(self._on_event)

    def reconcile_all(self) -> None:
        """Kept for callers that tick controllers in a loop: stamping is
        watch-driven, so a tick has nothing to poll."""

    def _on_event(self, event: str, kind: str, obj) -> None:
        if kind != "Pod":
            return
        pod = obj
        if pod.metadata.annotations.get("karpenter.sh/daemonset"):
            return
        node = pod.node_name or ""
        terminal = str(pod.phase) in ("Succeeded", "Failed") or pod.phase in (
            PodPhase.SUCCEEDED,
            PodPhase.FAILED,
        )
        # the sim marks eviction with pod.terminating (termination.py
        # _evict_locked); real deletes set deletion_timestamp — union both,
        # like termination.py's own is-terminating check
        terminating = (
            pod.metadata.deletion_timestamp is not None or pod.terminating
        )
        if event == DELETED:
            old = self._seen.pop(pod.uid, None)
            was_terminating = old is not None and old[2]
            if node and not was_terminating:
                self._stamp(node)
            return
        old = self._seen.get(pod.uid)
        self._seen[pod.uid] = (node, terminal, terminating)
        if not node:
            return
        bound = old is None or not old[0]
        went_terminal = terminal and (old is None or not old[1])
        went_terminating = terminating and (old is None or not old[2])
        if bound or went_terminal or went_terminating:
            self._stamp(node)

    def _stamp(self, node_name: str) -> None:
        # resolve node -> claim through the cluster index (one try_get)
        # instead of deep-copying every claim per pod event — pod churn is
        # the highest-frequency watch stream
        now = self.clock.now()
        sn = self.cluster.node_by_name(node_name)
        names: list[str]
        if sn is not None and sn.node_claim is not None:
            names = [sn.node_claim.name]
        else:
            # informer not caught up yet: fall back to the full scan
            names = [
                c.name
                for c in self.kube.list("NodeClaim")
                if c.status.node_name == node_name
            ]
        for name in names:
            claim = self.kube.try_get("NodeClaim", name)
            if claim is None or claim.status.node_name != node_name:
                continue
            last = claim.status.last_pod_event_time
            if last and now - last < self.DEDUPE_SECONDS:
                return
            claim.status.last_pod_event_time = now
            try:
                self.kube.update("NodeClaim", claim)
            except (Conflict, NotFound):
                pass
            return


class Expiration:
    """nodeclaim/expiration: delete claims older than expireAfter
    (controller.go:57)."""

    def __init__(self, kube: SimKube, clock, recorder: Optional[Recorder] = None):
        self.kube = kube
        self.clock = clock
        self.recorder = recorder

    def reconcile_all(self) -> int:
        expired = 0
        for claim in self.kube.list("NodeClaim"):
            if claim.metadata.deletion_timestamp is not None:
                continue
            if claim.expire_after_seconds is None:
                continue
            age = self.clock.now() - claim.metadata.creation_timestamp
            if age < claim.expire_after_seconds:
                continue
            self.kube.delete("NodeClaim", claim.name)
            CLAIMS_EXPIRED.inc({"nodepool": claim.nodepool_name or ""})
            if self.recorder:
                self.recorder.publish(
                    Event(
                        "NodeClaim", claim.name, "Normal", "Expired",
                        f"expired after {age:.0f}s",
                    )
                )
            expired += 1
        return expired


class GarbageCollection:
    """nodeclaim/garbagecollection: both directions (controller.go:60) —
    cloud instances without claims are terminated; launched claims whose
    instances vanished are deleted."""

    def __init__(self, kube: SimKube, cloud, clock):
        self.kube = kube
        self.cloud = cloud
        self.clock = clock

    def reconcile(self) -> tuple[int, int]:
        claims = self.kube.list("NodeClaim")
        claim_pids = {
            c.status.provider_id for c in claims if c.status.provider_id
        }
        # direction 1: instances with no claim
        orphans = 0
        for instance in list(self.cloud.list()):
            pid = instance.status.provider_id
            if pid and pid not in claim_pids:
                try:
                    self.cloud.delete(instance)
                    orphans += 1
                    CLAIMS_GARBAGE_COLLECTED.inc({"direction": "instance"})
                except Exception:
                    pass
        # direction 2: launched claims whose instance vanished
        live_pids = {
            i.status.provider_id for i in self.cloud.list() if i.status.provider_id
        }
        lost = 0
        for claim in claims:
            pid = claim.status.provider_id
            if not pid or claim.metadata.deletion_timestamp is not None:
                continue
            if pid not in live_pids:
                self.kube.delete("NodeClaim", claim.name)
                lost += 1
                CLAIMS_GARBAGE_COLLECTED.inc({"direction": "nodeclaim"})
        return orphans, lost


class Consistency:
    """nodeclaim/consistency: periodic invariant checks (nodeshape.go):
    the node's shape must match what the claim promised."""

    def __init__(self, kube: SimKube, cluster: Cluster, recorder: Optional[Recorder] = None):
        self.kube = kube
        self.cluster = cluster
        self.recorder = recorder

    def reconcile_all(self) -> list[str]:
        problems = []
        for claim in self.kube.list("NodeClaim"):
            if not claim.status.provider_id:
                continue  # consistency/controller.go:89
            issues = self._check(claim)
            if issues is None:
                continue  # node missing/deleting: lifecycle+GC own that
            cond = claim.status.conditions.get(COND_CONSISTENT_STATE_FOUND)
            want = "False" if issues else "True"
            if cond != want:
                claim.status.conditions[COND_CONSISTENT_STATE_FOUND] = want
                try:
                    self.kube.update("NodeClaim", claim)
                except (Conflict, NotFound):
                    pass
            for issue in issues:
                problems.append(f"{claim.name}: {issue}")
                if self.recorder:
                    self.recorder.publish(
                        Event("NodeClaim", claim.name, "Warning", "FailedConsistencyCheck", issue)
                    )
        return problems

    def _check(self, claim: NodeClaim) -> Optional[list[str]]:
        """The NodeShape check (consistency/nodeshape.go:35-58): for every
        resource the claim REQUESTED, the launched node's capacity must be
        at least 90% of the expected (claim status) capacity. Returns all
        issues found, or None when the claim is exempt (deleting, not yet
        initialized, or its node is not singular/present — controller.go:105
        delegates those to the lifecycle/GC controllers)."""
        if claim.metadata.deletion_timestamp is not None:
            return None
        if claim.status.conditions.get(COND_INITIALIZED) != "True":
            return None
        node = self.kube.try_get("Node", claim.status.node_name)
        if node is None:
            return None
        issues = []
        for name, requested in claim.resources_requests.items():
            expected = claim.status.capacity.get(name, 0)
            if not requested or not expected:
                continue
            got = node.capacity.get(name, 0)
            pct = got / expected
            if pct < 0.90:
                issues.append(
                    f"expected {expected} of resource {name}, but found "
                    f"{got} ({pct * 100:.1f}% of expected)"
                )
        return issues


class Hydration:
    """nodeclaim+node hydration (upgrade backfill): ensure objects carry
    the fields newer controllers expect. Mirrors BOTH reference hydration
    controllers: nodeclaim/hydration/controller.go:56-77 (the node-class
    label onto the NodeClaim) and node/hydration/controller.go:58-80 (the
    same label onto the claim's Node), plus the nodepool drift-hash
    annotations pre-hash-versioning claims lack."""

    def __init__(self, kube: SimKube):
        self.kube = kube

    def reconcile_all(self) -> None:
        nodepools = {np.name: np for np in self.kube.list("NodePool")}
        class_of_node: dict[str, str] = {}
        for claim in self.kube.list("NodeClaim"):
            np = nodepools.get(claim.nodepool_name)
            changed = False
            ann = claim.metadata.annotations
            if np is not None and well_known.NODEPOOL_HASH_ANNOTATION_KEY not in ann:
                ann[well_known.NODEPOOL_HASH_ANNOTATION_KEY] = nodepool_hash(np)
                ann[well_known.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = (
                    NODEPOOL_HASH_VERSION
                )
                changed = True
            # nodeclaim/hydration/controller.go:68: the node-class label
            labels = claim.metadata.labels
            if claim.node_class_ref and (
                labels.get(well_known.NODECLASS_LABEL_KEY) != claim.node_class_ref
            ):
                labels[well_known.NODECLASS_LABEL_KEY] = claim.node_class_ref
                changed = True
            if claim.status.node_name and claim.node_class_ref:
                class_of_node[claim.status.node_name] = claim.node_class_ref
            if changed:
                try:
                    self.kube.update("NodeClaim", claim)
                except (Conflict, NotFound):
                    pass
        # node/hydration/controller.go:74: same label onto the Node
        for node in self.kube.list("Node"):
            ref = class_of_node.get(node.name)
            if (
                not ref
                or node.metadata.labels.get(well_known.NODECLASS_LABEL_KEY) == ref
            ):
                continue
            node.metadata.labels[well_known.NODECLASS_LABEL_KEY] = ref
            try:
                self.kube.update("Node", node)
            except (Conflict, NotFound):
                pass
