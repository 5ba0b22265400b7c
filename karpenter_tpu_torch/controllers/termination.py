"""Node termination: the finalizer-driven drain.

Reference pkg/controllers/node/termination/:
- controller.go:91-289 (taint -> drain -> volume detach -> instance delete)
- terminator/terminator.go:96-176 (priority-grouped eviction, grace periods)
- terminator/eviction.go:93-230 (PDB-aware eviction queue)

Flow per reconcile of a deleting Node:
1. ensure the disrupted NoSchedule taint,
2. evict evictable pods in priority groups (PDB-gated), daemonsets last,
3. once drained, await VolumeAttachment deletion (the external
   attach-detach controller's job; skipped once terminationGracePeriod
   elapses — controller.go:223-252),
4. delete the cloud instance and drop the finalizer (the Node object then
   vanishes; the claim's finalizer completes next).
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import Node, Pod, PodPhase
from karpenter_tpu_torch.cloudprovider.types import NodeClaimNotFoundError
from karpenter_tpu_torch.controllers.kube import Conflict, NotFound, SimKube
from karpenter_tpu_torch.controllers.state import DISRUPTED_TAINT, Cluster
from karpenter_tpu_torch.events import Event, Recorder
from karpenter_tpu_torch import logging, metrics

NODES_DRAINED = metrics.REGISTRY.counter(
    "karpenter_nodes_drained_total", "Nodes fully drained by termination.", ("nodepool",)
)
PODS_EVICTED = metrics.REGISTRY.counter(
    "karpenter_nodes_evicted_pods_total", "Pods evicted during node drain."
)


def is_evictable(pod: Pod) -> bool:
    """terminator.go:96 groupPodsByPriority candidates: running/pending pods
    that aren't already terminal or terminating."""
    return (
        pod.phase in (PodPhase.PENDING, PodPhase.RUNNING)
        and pod.metadata.deletion_timestamp is None
        and not pod.terminating
    )


def is_daemonset(pod: Pod) -> bool:
    return bool(pod.metadata.annotations.get("karpenter.sh/daemonset"))


class NodeTermination:
    def __init__(
        self,
        kube: SimKube,
        cluster: Cluster,
        cloud_provider,
        clock,
        recorder: Optional[Recorder] = None,
        workers: int = 1,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud = cloud_provider
        self.clock = clock
        self.recorder = recorder or Recorder(clock)
        self.log = logging.root.named("node.termination")
        # reconciler pool width (reference termination/controller.go:58-60
        # scales 100->5000). Per-node reconciles are independent; SimKube
        # ops are atomic and cross-reconcile races surface as Conflict,
        # which reconcile() already treats as requeue-next-tick. PDB
        # accounting lives OUTSIDE that optimistic concurrency, so
        # evictions serialize under _evict_lock — the analog of the
        # reference's single eviction queue (terminator/eviction.go:93),
        # which exists for exactly this reason. Acquisition order is
        # _evict_lock -> SimKube._lock (evictions do CRUD under the evict
        # lock; SimKube never calls out while holding its own lock), so
        # the pair is acyclic. This direction is argued, not
        # mechanically pinned: re-argue it when touching either lock.
        import threading

        self._evict_lock = threading.Lock()
        self.workers = workers

    def reconcile_all(self) -> None:
        from karpenter_tpu_torch.utils.workerpool import parallelize_until

        names = [
            node.name
            for node in self.kube.list("Node")
            if node.metadata.deletion_timestamp is not None
        ]
        errs = parallelize_until(
            self.workers, len(names), lambda i: self.reconcile(names[i])
        )
        for name, err in zip(names, errs):
            if err is not None:
                self.log.error(
                    "termination reconcile failed", node=name, error=str(err)
                )

    def reconcile(self, name: str) -> Optional[str]:
        node = self.kube.try_get("Node", name)
        if node is None:
            return None
        if node.metadata.deletion_timestamp is None:
            return None
        if well_known.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return None

        # 1. taint (terminator.go Taint; statenode.go:483 RequireNoScheduleTaint)
        if DISRUPTED_TAINT not in node.taints:
            node.taints = list(node.taints) + [DISRUPTED_TAINT]
            try:
                node = self.kube.update("Node", node)
            except (Conflict, NotFound):
                return None
            if node is None:
                return None

        # enforce terminationGracePeriod on the claim if set
        claim = self._claim_for(node)
        force = False
        if (
            claim is not None
            and claim.termination_grace_period_seconds is not None
            and node.metadata.deletion_timestamp is not None
        ):
            force = (
                self.clock.now() - node.metadata.deletion_timestamp
                > claim.termination_grace_period_seconds
            )

        # 2. drain: evict in ascending priority groups, workload pods before
        # daemonset pods (terminator.go:96 groupPodsByPriority)
        pods = self.kube.list("Pod", lambda p: p.node_name == name)
        workload = [p for p in pods if is_evictable(p) and not is_daemonset(p)]
        if workload:
            lowest = min(p.priority for p in workload)
            group = [p for p in workload if p.priority == lowest]
            evicted = self._evict(group, force)
            if evicted:
                return "draining"
            if not force:
                return "drain-blocked"
        daemons = [p for p in pods if is_evictable(p) and is_daemonset(p)]
        if daemons:
            if self._evict(daemons, force):
                return "draining"
            if not force:
                return "drain-blocked"
        # terminating pods still exiting?
        if any(
            p.terminating or p.metadata.deletion_timestamp is not None
            for p in pods
        ):
            self._finish_evictions(name)
            if self.kube.list("Pod", lambda p: p.node_name == name):
                return "awaiting-pod-exit"

        nodepool = node.metadata.labels.get(well_known.NODEPOOL_LABEL_KEY, "")
        NODES_DRAINED.inc({"nodepool": nodepool})

        # 3. await volume detachment (controller.go:223-252): the external
        # attach-detach controller deletes VolumeAttachments after unmount;
        # instance deletion blocks until the node's attachments are gone —
        # unless the claim's terminationGracePeriod has elapsed (force),
        # matching hasTerminationGracePeriodElapsed's skip.
        if not force:
            pending = self._pending_volume_attachments(name)
            if pending:
                self.recorder.publish(
                    Event(
                        "Node", name, "Normal", "AwaitingVolumeDetachment",
                        f"awaiting deletion of {len(pending)} volume "
                        "attachment(s)",
                    )
                )
                return "awaiting-volume-detachment"

        # 4. instance deletion + finalizer removal (controller.go:269)
        if claim is not None:
            try:
                self.cloud.delete(claim)
            except NodeClaimNotFoundError:
                pass
        node = self.kube.try_get("Node", name)
        if node is None:
            return "terminated"
        node.metadata.finalizers = [
            f for f in node.metadata.finalizers if f != well_known.TERMINATION_FINALIZER
        ]
        try:
            self.kube.update("Node", node)
        except (Conflict, NotFound):
            return None
        self.recorder.publish(
            Event("Node", name, "Normal", "Terminated", "node drained and removed")
        )
        self.log.info("terminated node", node=name, nodepool=nodepool)
        return "terminated"

    def _pending_volume_attachments(self, node_name: str) -> list:
        """controller.go:296 pendingVolumeAttachments: the node's
        VolumeAttachments minus those belonging to non-drainable pods
        (filterVolumeAttachments — pods termination won't evict keep their
        volumes mounted forever; waiting on them would deadlock)."""
        vas = self.kube.list(
            "VolumeAttachment", lambda va: va.node_name == node_name
        )
        if not vas:
            return []
        undrainable_vols: set[str] = set()
        for p in self.kube.list("Pod", lambda p: p.node_name == node_name and not is_evictable(p)):
            undrainable_vols.update(p.volume_claims)
        return [va for va in vas if va.volume_name not in undrainable_vols]

    # -- eviction ---------------------------------------------------------

    def _evict(self, pods: list[Pod], force: bool) -> int:
        """PDB-aware evictions (eviction.go:93). Returns how many started.
        Snapshot-to-mark is atomic under _evict_lock: two workers evicting
        different pods under one PDB would otherwise both act on a stale
        allowed-count and jointly overrun the budget."""
        with self._evict_lock:
            return self._evict_locked(pods, force)

    def _evict_locked(self, pods: list[Pod], force: bool) -> int:
        from karpenter_tpu_torch.utils.pdb import PDBLimits

        limits = PDBLimits.from_kube(self.kube)
        count = 0
        for pod in pods:
            if not force:
                blocked = limits.is_fully_blocked(pod)
                ok, reason = limits.can_evict(pod)
                if blocked is not None or not ok:
                    self.recorder.publish(
                        Event(
                            "Pod", pod.name, "Warning", "EvictionBlocked",
                            blocked or reason or "",
                        )
                    )
                    continue
                limits.record_eviction(pod)
            pod.terminating = True
            try:
                self.kube.update("Pod", pod)
            except (Conflict, NotFound):
                continue
            PODS_EVICTED.inc()
            count += 1
        return count

    def _finish_evictions(self, node_name: str) -> None:
        """Terminating pods exit after their grace period (the kubelet's
        role, simulated)."""
        for pod in self.kube.list("Pod", lambda p: p.node_name == node_name and p.terminating):
            try:
                self.kube.delete("Pod", pod.name)
            except NotFound:
                pass

    def _claim_for(self, node: Node):
        sn = self.cluster.node_by_name(node.name)
        if sn is not None and sn.node_claim is not None:
            return self.kube.try_get("NodeClaim", sn.node_claim.name)
        return None
