"""Cluster-state cache (L3): the in-memory mirror every controller reads.

Reference: Cluster (pkg/controllers/state/cluster.go:54-210),
StateNode (statenode.go:119-560), informer controllers
(state/informer/{pod,node,nodeclaim,nodepool,daemonset}.go).

`wire_informers` subscribes the cluster to SimKube watch events, exactly like
the reference's informer controllers feed Cluster from apiserver watches. The
`synced` barrier replicates cluster.go:118 Synced(): no scheduling or
disruption decision may run until the cache reflects every NodeClaim/Node in
the store — the logical-race guard that makes solver state safely ephemeral
(SURVEY.md §5.4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    COND_INITIALIZED,
    COND_REGISTERED,
    Node,
    NodeClaim,
    NodePool,
    Pod,
    PodPhase,
    Taint,
)
from karpenter_tpu_torch.scheduling.hostports import HostPortUsage, get_host_ports
from karpenter_tpu_torch.scheduling.volumeusage import VolumeUsage
from karpenter_tpu_torch.solver.nodes import StateNodeView
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList

# The taint the lifecycle controller removes at registration
# (reference apis/v1/taints.go UnregisteredNoExecuteTaint)
UNREGISTERED_TAINT = Taint(
    key="karpenter.sh/unregistered", effect="NoExecute", value=""
)
# Disruption's "disrupting" taint (reference apis/v1/taints.go DisruptedNoScheduleTaint)
DISRUPTED_TAINT = Taint(key="karpenter.sh/disrupted", effect="NoSchedule", value="")

NOMINATION_WINDOW_SECONDS = 20.0  # statenode.go:431 nomination window


def is_provisionable(pod: Pod) -> bool:
    """pod.IsProvisionable (reference pkg/utils/pod/scheduling.go:42): pending,
    unbound, not gated, not terminating."""
    return (
        not pod.node_name
        and pod.phase == PodPhase.PENDING
        and not pod.scheduling_gates
        and pod.metadata.deletion_timestamp is None
        and not pod.terminating
    )


def is_reschedulable(pod: Pod) -> bool:
    """Pods worth rescheduling when their node goes away (reference
    pkg/utils/pod/scheduling.go IsReschedulable): running/pending workload
    pods, not terminal, not terminating, and not owned by a node (daemonset
    pods are re-created by their controller on the replacement node)."""
    return (
        pod.phase in (PodPhase.PENDING, PodPhase.RUNNING)
        and pod.metadata.deletion_timestamp is None
        and not pod.terminating
        and not pod.metadata.annotations.get("karpenter.sh/daemonset")
    )


def has_required_anti_affinity(pod: Pod) -> bool:
    return bool(pod.pod_anti_affinity)


class StateNode:
    """A Node+NodeClaim pair keyed by provider id (statenode.go:119)."""

    def __init__(self) -> None:
        self.node: Optional[Node] = None
        self.node_claim: Optional[NodeClaim] = None
        self.marked_for_deletion: bool = False
        self.nominated_until: float = 0.0
        # pod uid -> requests (bound pods), split daemonset vs workload
        self.pod_requests: dict[str, ResourceList] = {}
        self.daemonset_requests: dict[str, ResourceList] = {}
        self.host_port_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()

    # -- identity ---------------------------------------------------------

    @property
    def name(self) -> str:
        if self.node is not None:
            return self.node.name
        return self.node_claim.status.node_name or self.node_claim.name

    @property
    def provider_id(self) -> str:
        if self.node is not None and self.node.provider_id:
            return self.node.provider_id
        if self.node_claim is not None:
            return self.node_claim.status.provider_id or f"claim://{self.node_claim.name}"
        return ""

    @property
    def nodepool_name(self) -> Optional[str]:
        return self.labels().get(well_known.NODEPOOL_LABEL_KEY)

    def owned(self) -> bool:
        """Managed by this autoscaler (has a NodeClaim or the nodepool label)."""
        return self.node_claim is not None or (
            self.node is not None
            and well_known.NODEPOOL_LABEL_KEY in self.node.metadata.labels
        )

    # -- shape ------------------------------------------------------------

    def labels(self) -> dict[str, str]:
        if self.node is not None:
            return dict(self.node.metadata.labels)
        if self.node_claim is not None:
            out = dict(self.node_claim.metadata.labels)
            for r in self.node_claim.requirements:
                if r.operator == "In" and len(r.values) == 1:
                    out.setdefault(r.key, r.values[0])
            return out
        return {}

    def taints(self) -> list[Taint]:
        """Registered nodes: real node taints minus the bootstrap taint.

        UNINITIALIZED nodes that are MANAGED (node_claim present —
        statenode.go:439 Managed) reject the well-known ephemeral taints
        (not-ready/unreachable/...) and the claim's startup taints
        (statenode.go:311-325): those are expected to clear before
        initialization, so the scheduler assumes pods can land once they
        do. The same rejection applies to in-flight claims that have no
        node yet — their startup taints never block scheduling before
        initialization. After initialization every taint is taken at face
        value (a re-appearing not-ready then means cordoned); claim-less
        labeled nodes always are (the reference treats them unmanaged)."""
        from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS

        managed = self.node_claim is not None
        assume_boot = managed and not self.initialized()

        def reject_boot(taints: list[Taint]) -> list[Taint]:
            # MatchTaint semantics: key + effect (value ignored)
            reject = {
                (t.key, t.effect)
                for t in list(KNOWN_EPHEMERAL_TAINTS)
                + list(self.node_claim.startup_taints)
            }
            return [t for t in taints if (t.key, t.effect) not in reject]

        if self.node is not None and self.registered():
            taints = [t for t in self.node.taints if t != UNREGISTERED_TAINT]
            if assume_boot:
                taints = reject_boot(taints)
            return taints
        # remaining cases all carry a claim: claim-only, or a joined node
        # that hasn't registered (registered() is True whenever node is
        # present WITHOUT a claim, so that combination never reaches here)
        if self.node_claim is not None:
            out = list(self.node_claim.taints) + list(
                self.node_claim.startup_taints
            )
            return reject_boot(out) if assume_boot else out
        return []

    def capacity(self) -> ResourceList:
        if self.node is not None and self.node.capacity:
            return dict(self.node.capacity)
        if self.node_claim is not None:
            return dict(self.node_claim.status.capacity)
        return {}

    def allocatable(self) -> ResourceList:
        if self.node is not None and self.node.allocatable:
            return dict(self.node.allocatable)
        if self.node_claim is not None:
            return dict(self.node_claim.status.allocatable)
        return {}

    # -- lifecycle --------------------------------------------------------

    def registered(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.status.conditions.get(COND_REGISTERED) == "True"
        return self.node is not None  # unmanaged nodes are registered by definition

    def initialized(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.status.conditions.get(COND_INITIALIZED) == "True"
        return self.node is not None and self.node.ready

    def deleting(self) -> bool:
        if self.node is not None and self.node.metadata.deletion_timestamp is not None:
            return True
        if (
            self.node_claim is not None
            and self.node_claim.metadata.deletion_timestamp is not None
        ):
            return True
        return False

    def nominate(self, now: float) -> None:
        self.nominated_until = now + NOMINATION_WINDOW_SECONDS

    def nominated(self, now: float) -> bool:
        return now < self.nominated_until

    # -- resources --------------------------------------------------------

    def pods_requests_total(self) -> ResourceList:
        out: ResourceList = {}
        for r in self.pod_requests.values():
            out = res.merge(out, r)
        return out

    def daemonset_requests_total(self) -> ResourceList:
        out: ResourceList = {}
        for r in self.daemonset_requests.values():
            out = res.merge(out, r)
        return out

    def available(self) -> ResourceList:
        """allocatable minus all bound pod requests (workload + daemon)."""
        used = res.merge(self.pods_requests_total(), self.daemonset_requests_total())
        return res.subtract(self.allocatable(), used)

    # -- views ------------------------------------------------------------

    def to_view(self) -> StateNodeView:
        return StateNodeView(
            name=self.name,
            node_labels=dict(self.node.metadata.labels) if self.node else None,
            labels=self.labels(),
            taints=self.taints(),
            available=self.available(),
            capacity=self.capacity(),
            daemonset_requests=self.daemonset_requests_total(),
            initialized=self.initialized(),
            hostname=self.labels().get(well_known.HOSTNAME_LABEL_KEY, self.name),
            host_port_usage=self.host_port_usage.copy(),
            volume_usage=self.volume_usage.copy(),
            csi_allocatable=dict(self.node.csi_allocatable)
            if self.node is not None
            else {},
        )


class NodePoolState:
    """statenodepool.go: per-pool active / deleting / pending-disruption
    NodeClaim name sets plus node-count reservations. The reservation path
    lets static provisioning and StaticDrift scale decisions coordinate
    against a pool's `nodes` limit without bursting over it
    (statenodepool.go:137 ReserveNodeCount)."""

    def __init__(self) -> None:
        self._pools: dict[str, dict[str, set[str]]] = {}
        self._claim_to_pool: dict[str, str] = {}
        self._reserved: dict[str, int] = {}

    def _entry(self, pool: str) -> dict[str, set[str]]:
        e = self._pools.get(pool)
        if e is None:
            e = {"active": set(), "deleting": set(), "pending": set()}
            self._pools[pool] = e
            self._reserved.setdefault(pool, 0)
        return e

    def mark_active(self, pool: str, claim: str) -> None:
        e = self._entry(pool)
        e["pending"].discard(claim)
        e["deleting"].discard(claim)
        e["active"].add(claim)
        self._claim_to_pool[claim] = pool

    def mark_deleting(self, pool: str, claim: str) -> None:
        e = self._entry(pool)
        e["pending"].discard(claim)
        e["active"].discard(claim)
        e["deleting"].add(claim)
        self._claim_to_pool[claim] = pool

    def mark_pending_disruption(self, pool: str, claim: str) -> None:
        e = self._entry(pool)
        e["active"].discard(claim)
        e["deleting"].discard(claim)
        e["pending"].add(claim)
        self._claim_to_pool[claim] = pool

    def cleanup(self, claim: str) -> None:
        """statenodepool.go:106: drop the claim; drop the pool entry once
        nothing active or deleting remains."""
        pool = self._claim_to_pool.pop(claim, None)
        if pool is None:
            return
        e = self._pools.get(pool)
        if e is None:
            return
        for s in e.values():
            s.discard(claim)
        if not e["active"] and not e["deleting"]:
            self._pools.pop(pool, None)
            # reservations held by in-flight commands must survive the pool
            # entry going empty, or a concurrent scale-up could burst the
            # node limit while the command's launch is still pending
            if self._reserved.get(pool, 0) == 0:
                self._reserved.pop(pool, None)

    def node_counts(self, pool: str) -> tuple[int, int, int]:
        """(active, deleting, pending_disruption)"""
        e = self._pools.get(pool)
        if e is None:
            return 0, 0, 0
        return len(e["active"]), len(e["deleting"]), len(e["pending"])

    def reserve_node_count(self, pool: str, limit: float, wanted: int) -> int:
        """Grant up to `wanted` new-node reservations without active +
        deleting + pending + reserved exceeding `limit`."""
        self._entry(pool)
        a, d, p = self.node_counts(pool)
        remaining = limit - (a + d + p) - self._reserved[pool]
        if remaining < 0:
            return 0
        granted = int(min(wanted, remaining))
        self._reserved[pool] += max(0, granted)
        return max(0, granted)

    def release_node_count(self, pool: str, count: int = 1) -> None:
        self._reserved[pool] = max(0, self._reserved.get(pool, 0) - count)

    def update_node_claim(self, claim: NodeClaim, marked_for_deletion: bool) -> None:
        pool = claim.nodepool_name
        if not pool:
            return
        if marked_for_deletion:
            self.mark_deleting(pool, claim.name)
        else:
            self.mark_active(pool, claim.name)


class Cluster:
    """cluster.go:54 — the shared in-memory mirror."""

    def __init__(self, clock) -> None:
        self.clock = clock
        # set by wire_informers: fills pod.volume_drivers from PVC ->
        # StorageClass.provisioner (VolumeTopology.resolve_drivers)
        self.volume_driver_resolver = None
        self.nodes: dict[str, StateNode] = {}  # provider id -> StateNode
        self.node_name_to_pid: dict[str, str] = {}
        self.claim_name_to_pid: dict[str, str] = {}
        self.bindings: dict[str, str] = {}  # pod uid -> node name
        self.pods: dict[str, Pod] = {}  # pod uid -> latest copy
        self.nodepools: dict[str, NodePool] = {}
        self.daemonsets: dict[str, object] = {}
        self.anti_affinity_pods: dict[str, Pod] = {}
        # pod uid -> (node name decided, timestamp) from the last Solve
        self.pod_scheduling_decisions: dict[str, tuple[str, float]] = {}
        self._consolidated_at: float = -1.0
        self.nodepool_state = NodePoolState()  # cluster.go:68

    # -- Synced barrier (cluster.go:118) ---------------------------------

    def synced(self, kube) -> bool:
        """The state must be a superset of the store: every NodeClaim and
        Node currently in the store is reflected here. Controllers requeue
        until this holds (the logical-race guard)."""
        for claim in kube.list("NodeClaim"):
            if claim.name not in self.claim_name_to_pid:
                return False
        for node in kube.list("Node"):
            if node.name not in self.node_name_to_pid:
                return False
        return True

    # -- consolidation timestamp (cluster.go:550) ------------------------

    def mark_unconsolidated(self) -> None:
        self._consolidated_at = -1.0

    def mark_consolidated(self) -> None:
        self._consolidated_at = self.clock.now()

    def consolidated(self) -> bool:
        """True while nothing changed since the last full consolidation scan
        (5-minute falloff like the reference)."""
        return (
            self._consolidated_at >= 0
            and self.clock.now() - self._consolidated_at < 300.0
        )

    # -- node/claim ingestion --------------------------------------------

    def _state_node_for(self, pid: str) -> StateNode:
        sn = self.nodes.get(pid)
        if sn is None:
            sn = StateNode()
            self.nodes[pid] = sn
        return sn

    def _rekey(self, old_pid: str, new_pid: str) -> None:
        if old_pid == new_pid or old_pid not in self.nodes:
            return
        moved = self.nodes.pop(old_pid)
        existing = self.nodes.get(new_pid)
        if existing is not None:
            # merge: keep the richer side (node from one, claim from other)
            existing.node = existing.node or moved.node
            existing.node_claim = existing.node_claim or moved.node_claim
            existing.marked_for_deletion |= moved.marked_for_deletion
            moved = existing
        self.nodes[new_pid] = moved
        for m in (self.node_name_to_pid, self.claim_name_to_pid):
            for name, pid in list(m.items()):
                if pid == old_pid:
                    m[name] = new_pid

    def update_nodeclaim(self, claim: NodeClaim) -> None:
        old_pid = self.claim_name_to_pid.get(claim.name)
        new_pid = claim.status.provider_id or f"claim://{claim.name}"
        if old_pid is not None and old_pid != new_pid:
            self._rekey(old_pid, new_pid)
        sn = self._state_node_for(new_pid)
        sn.node_claim = claim
        self.claim_name_to_pid[claim.name] = new_pid
        # cluster.go:331: keep the per-pool claim-state sets in step
        self.nodepool_state.update_node_claim(
            claim,
            claim.metadata.deletion_timestamp is not None or sn.marked_for_deletion,
        )
        self.mark_unconsolidated()

    def delete_nodeclaim(self, name: str) -> None:
        self.nodepool_state.cleanup(name)  # cluster.go:678
        pid = self.claim_name_to_pid.pop(name, None)
        if pid is None:
            return
        sn = self.nodes.get(pid)
        if sn is not None:
            sn.node_claim = None
            if sn.node is None:
                del self.nodes[pid]
        self.mark_unconsolidated()

    def update_node(self, node: Node) -> None:
        old_pid = self.node_name_to_pid.get(node.name)
        new_pid = node.provider_id or f"node://{node.name}"
        if old_pid is not None and old_pid != new_pid:
            self._rekey(old_pid, new_pid)
        # a claim may already hold this provider id
        if node.provider_id and node.provider_id not in self.nodes:
            # the claim might be keyed by claim:// placeholder; match by
            # status.node_name
            for pid, sn in list(self.nodes.items()):
                if (
                    sn.node_claim is not None
                    and sn.node_claim.status.provider_id == node.provider_id
                ):
                    self._rekey(pid, node.provider_id)
                    break
        sn = self._state_node_for(new_pid)
        sn.node = node
        self.node_name_to_pid[node.name] = new_pid
        # backfill pods bound to this node before it reached the cache (the
        # pod informer fired first): their requests were never tallied
        for uid, bound_node in self.bindings.items():
            if bound_node != node.name:
                continue
            pod = self.pods.get(uid)
            if pod is None or uid in sn.pod_requests or uid in sn.daemonset_requests:
                continue
            self._apply_bind(pod, sn)
        self.mark_unconsolidated()

    def delete_node(self, name: str) -> None:
        pid = self.node_name_to_pid.pop(name, None)
        if pid is None:
            return
        sn = self.nodes.get(pid)
        if sn is not None:
            sn.node = None
            if sn.node_claim is None:
                del self.nodes[pid]
        self.mark_unconsolidated()

    # -- pod ingestion ----------------------------------------------------

    def update_pod(self, pod: Pod) -> None:
        uid = pod.uid
        # only TERMINAL pods release their node usage (cluster.go UpdatePod):
        # a deleting-but-running pod still occupies capacity and still pins
        # its anti-affinity domains until the delete event arrives
        gone = pod.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)
        old_node = self.bindings.get(uid)
        if old_node is not None and (gone or pod.node_name != old_node):
            self._unbind(uid, old_node)
        if not gone and pod.node_name and self.bindings.get(uid) != pod.node_name:
            self._bind(pod, pod.node_name)
        if gone:
            self.pods.pop(uid, None)
            self.anti_affinity_pods.pop(uid, None)
        else:
            self.pods[uid] = pod
            if has_required_anti_affinity(pod):
                self.anti_affinity_pods[uid] = pod
            else:
                self.anti_affinity_pods.pop(uid, None)
        self.mark_unconsolidated()

    def delete_pod(self, pod: Pod) -> None:
        uid = pod.uid
        old_node = self.bindings.get(uid)
        if old_node is not None:
            self._unbind(uid, old_node)
        self.pods.pop(uid, None)
        self.anti_affinity_pods.pop(uid, None)
        self.pod_scheduling_decisions.pop(uid, None)
        self.mark_unconsolidated()

    def _bind(self, pod: Pod, node_name: str) -> None:
        self.bindings[pod.uid] = node_name
        pid = self.node_name_to_pid.get(node_name)
        sn = self.nodes.get(pid) if pid else None
        if sn is None:
            return  # node not cached yet; update_node backfills on arrival
        self._apply_bind(pod, sn)

    def _apply_bind(self, pod: Pod, sn: StateNode) -> None:
        requests = res.requests_for_pods([pod])
        if pod.metadata.annotations.get("karpenter.sh/daemonset"):
            sn.daemonset_requests[pod.uid] = requests
        else:
            sn.pod_requests[pod.uid] = requests
        sn.host_port_usage.add(pod, get_host_ports(pod))
        if pod.volume_claims and self.volume_driver_resolver is not None:
            # attribute the bound pod's volumes to their CSI drivers the
            # same way the provisioner's inject does — per-driver budgets
            # must see existing usage in the right bucket
            self.volume_driver_resolver(pod)
        sn.volume_usage.add(pod)

    def _unbind(self, uid: str, node_name: str) -> None:
        self.bindings.pop(uid, None)
        pid = self.node_name_to_pid.get(node_name)
        sn = self.nodes.get(pid) if pid else None
        if sn is None:
            return
        sn.pod_requests.pop(uid, None)
        sn.daemonset_requests.pop(uid, None)
        sn.host_port_usage.remove(uid)
        sn.volume_usage.remove(uid)

    # -- nodepool / daemonset --------------------------------------------

    def update_nodepool(self, np: NodePool) -> None:
        self.nodepools[np.name] = np
        self.mark_unconsolidated()

    def delete_nodepool(self, name: str) -> None:
        self.nodepools.pop(name, None)
        self.mark_unconsolidated()

    def update_daemonset(self, ds) -> None:
        self.daemonsets[ds.name] = ds
        self.mark_unconsolidated()

    def delete_daemonset(self, name: str) -> None:
        self.daemonsets.pop(name, None)

    # -- queries ----------------------------------------------------------

    def state_nodes(self) -> list[StateNode]:
        return list(self.nodes.values())

    def node_by_name(self, name: str) -> Optional[StateNode]:
        pid = self.node_name_to_pid.get(name)
        return self.nodes.get(pid) if pid else None

    def node_by_claim_name(self, name: str) -> Optional[StateNode]:
        pid = self.claim_name_to_pid.get(name)
        return self.nodes.get(pid) if pid else None

    def pods_on(self, node_name: str) -> list[Pod]:
        return [
            self.pods[uid]
            for uid, n in self.bindings.items()
            if n == node_name and uid in self.pods
        ]

    def mark_for_deletion(self, *names: str) -> None:
        for name in names:
            sn = self.node_by_name(name) or self.node_by_claim_name(name)
            if sn is not None:
                sn.marked_for_deletion = True
                if sn.node_claim is not None:  # cluster.go:308
                    self.nodepool_state.mark_deleting(
                        sn.nodepool_name or "", sn.node_claim.name
                    )
        self.mark_unconsolidated()

    def unmark_for_deletion(self, *names: str) -> None:
        for name in names:
            sn = self.node_by_name(name) or self.node_by_claim_name(name)
            if sn is not None:
                sn.marked_for_deletion = False
                if sn.node_claim is not None:  # cluster.go:291
                    self.nodepool_state.mark_active(
                        sn.nodepool_name or "", sn.node_claim.name
                    )

    def schedulable_node_views(self) -> list[StateNodeView]:
        """The ExistingNode inputs for a provisioning Solve: registered,
        not deleting, not marked for deletion (scheduler.go existing-node
        selection).

        LAUNCHED claim-only StateNodes (no registered node yet) are
        in-flight capacity exactly as in the reference (cluster.Nodes
        feeds them to the scheduler): pods placed on them nominate and
        stay pending until the node registers — _bind_to_existing skips
        nodes that aren't ready — so a cross-batch pod arriving during
        the registration window packs onto the in-flight claim instead of
        forking a second one (suite_test.go:1832). StateNode.taints()
        rejects their startup/ephemeral taints until initialization
        (statenode.go:311-325)."""
        out = []
        for sn in self.nodes.values():
            if sn.marked_for_deletion or sn.deleting():
                continue
            registered_node = sn.node is not None and sn.registered()
            # in-flight capacity: a LAUNCHED claim (capacity known) counts
            # whether its node hasn't appeared yet OR has joined but not
            # registered — both are the same window to the scheduler
            launched_claim = (
                sn.node_claim is not None
                and bool(sn.node_claim.status.provider_id)
                and bool(sn.node_claim.status.allocatable)
            )
            if not registered_node and not launched_claim:
                continue
            out.append(sn.to_view())
        return out

    def mark_pod_scheduling_decisions(
        self, assignments: dict[str, str]
    ) -> None:
        now = self.clock.now()
        for uid, node in assignments.items():
            self.pod_scheduling_decisions[uid] = (node, now)


def cluster_source(kube, cluster: "Cluster", exclude_nodes: frozenset = frozenset()):
    """The ClusterSource every scheduling simulation feeds Topology: all
    scheduled pods by namespace, node objects by name, and namespace labels
    for affinity namespaceSelector resolution (topology.go:328 countDomains
    + :503 buildNamespaceList)."""
    from karpenter_tpu_torch.solver.topology import ClusterSource

    pods_by_ns: dict[str, list[Pod]] = {}
    for p in cluster.pods.values():
        if exclude_nodes and cluster.bindings.get(p.uid) in exclude_nodes:
            continue
        pods_by_ns.setdefault(p.namespace, []).append(p)
    nodes_by_name = {
        sn.name: sn.node
        for sn in cluster.state_nodes()
        if sn.node is not None and sn.name not in exclude_nodes
    }
    namespace_labels = {
        ns.name: dict(ns.labels) for ns in kube.list("Namespace")
    }
    return ClusterSource(pods_by_ns, nodes_by_name, namespace_labels)


def wire_informers(kube, cluster: Cluster) -> None:
    """Subscribe the cluster cache to SimKube watch events — the analog of
    the reference's five informer controllers (state/informer/*.go)."""
    from karpenter_tpu_torch.controllers.provisioning import VolumeTopology

    cluster.volume_driver_resolver = VolumeTopology(kube).resolve_drivers

    def handler(event: str, kind: str, obj) -> None:
        deleted = event == "deleted"
        if kind == "NodeClaim":
            cluster.delete_nodeclaim(obj.name) if deleted else cluster.update_nodeclaim(obj)
        elif kind == "Node":
            cluster.delete_node(obj.name) if deleted else cluster.update_node(obj)
        elif kind == "Pod":
            cluster.delete_pod(obj) if deleted else cluster.update_pod(obj)
        elif kind == "NodePool":
            cluster.delete_nodepool(obj.name) if deleted else cluster.update_nodepool(obj)
        elif kind == "DaemonSet":
            cluster.delete_daemonset(obj.name) if deleted else cluster.update_daemonset(obj)

    kube.subscribe(handler)
