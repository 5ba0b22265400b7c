"""Cluster-observability metric controllers: per-node gauges, per-nodepool
limits/usage, and pod lifecycle timings.

Reference pkg/controllers/metrics/:
- node/controller.go:176 (per-node allocatable/usage gauge families)
- nodepool/controller.go:93 (limit gauges)
- pod/controller.go:209-447 (pod state, scheduling-undecided/unbound
  durations, startup time)
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api.objects import PodPhase
from karpenter_tpu_torch.controllers.state import Cluster, is_provisionable
from karpenter_tpu_torch import metrics

NODE_ALLOCATABLE = metrics.REGISTRY.gauge(
    "karpenter_nodes_allocatable",
    "Node allocatable by resource type.",
    ("node_name", "nodepool", "resource_type"),
)
NODE_USAGE = metrics.REGISTRY.gauge(
    "karpenter_nodes_total_pod_requests",
    "Total pod requests per node by resource type.",
    ("node_name", "nodepool", "resource_type"),
)
NODEPOOL_LIMIT = metrics.REGISTRY.gauge(
    "karpenter_nodepools_limit",
    "NodePool resource limits.",
    ("nodepool", "resource_type"),
)
POD_STATE = metrics.REGISTRY.gauge(
    "karpenter_pods_current_state", "Pods by phase.", ("phase",)
)
POD_STARTUP = metrics.REGISTRY.histogram(
    "karpenter_pods_startup_duration_seconds",
    "Time from pod creation to running.",
)
POD_UNDECIDED = metrics.REGISTRY.gauge(
    "karpenter_pods_scheduling_undecided", "Provisionable pods with no decision yet."
)
# pod lifecycle timing family (pod/controller.go:286-447, round 5):
# per-pod "still waiting" gauges deleted on resolution + duration
# histograms observed once at the transition
POD_BOUND_DURATION = metrics.REGISTRY.histogram(
    "karpenter_pods_bound_duration_seconds",
    "Time from pod creation to binding (PodBoundDurationSeconds).",
)
POD_UNBOUND_TIME = metrics.REGISTRY.gauge(
    "karpenter_pods_current_unbound_time_seconds",
    "Per-pod time since creation while still unbound.",
    ("name", "namespace"),
)
POD_UNSTARTED_TIME = metrics.REGISTRY.gauge(
    "karpenter_pods_unstarted_time_seconds",
    "Per-pod time since creation while not yet running.",
    ("name", "namespace"),
)
POD_SCHEDULING_DECISION = metrics.REGISTRY.histogram(
    "karpenter_pods_scheduling_decision_duration_seconds",
    "Time from first seeing a provisionable pod to a scheduling decision.",
)

_node_store = metrics.Store(NODE_ALLOCATABLE)
_usage_store = metrics.Store(NODE_USAGE)


class NodeMetricsController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile_all(self) -> None:
        seen = set()
        for sn in self.cluster.state_nodes():
            if sn.node is None:
                continue
            seen.add(sn.name)
            np_name = sn.nodepool_name or ""
            _node_store.update(
                sn.name,
                [
                    (
                        {
                            "node_name": sn.name,
                            "nodepool": np_name,
                            "resource_type": rname,
                        },
                        float(v),
                    )
                    for rname, v in sn.allocatable().items()
                ],
            )
            _usage_store.update(
                f"usage/{sn.name}",
                [
                    (
                        {
                            "node_name": sn.name,
                            "nodepool": np_name,
                            "resource_type": rname,
                        },
                        float(v),
                    )
                    for rname, v in sn.pods_requests_total().items()
                ],
            )
        # GC series for vanished nodes
        for key in list(_node_store._owned):
            if key not in seen:
                _node_store.delete(key)
        for key in list(_usage_store._owned):
            if key.startswith("usage/") and key[len("usage/"):] not in seen:
                _usage_store.delete(key)


class NodePoolMetricsController:
    def __init__(self, kube):
        self.kube = kube

    def reconcile_all(self) -> None:
        for np in self.kube.list("NodePool"):
            for rname, v in np.limits.items():
                NODEPOOL_LIMIT.set(
                    float(v), {"nodepool": np.name, "resource_type": rname}
                )


class PodMetricsController:
    """metrics/pod/controller.go:209-447, reduced to the sim's pod model:
    binding = node_name set (no PodScheduled condition object), started =
    phase Running. Waiting gauges are per-pod and deleted idempotently on
    resolution exactly like the reference's; durations observe once."""

    def __init__(self, kube, cluster: Cluster, clock):
        self.kube = kube
        self.cluster = cluster
        self.clock = clock
        self._started: set[str] = set()
        self._bound: set[str] = set()
        self._acked: dict[str, float] = {}  # uid -> first provisionable time
        self._decided: set[str] = set()
        # waiting gauges GC through keyed Stores (store.go:33), same
        # pattern the node gauge families use above
        self._unbound_store = metrics.Store(POD_UNBOUND_TIME)
        self._unstarted_store = metrics.Store(POD_UNSTARTED_TIME)

    def reconcile_all(self) -> None:
        now = self.clock.now()
        counts: dict[str, int] = {}
        undecided = 0
        live_waiting: set[tuple[str, str]] = set()
        live_uids: set[str] = set()
        for pod in self.kube.list("Pod"):
            live_uids.add(pod.uid)
            counts[str(pod.phase.value)] = counts.get(str(pod.phase.value), 0) + 1
            labels = {"name": pod.name, "namespace": pod.namespace}
            created = pod.metadata.creation_timestamp
            if is_provisionable(pod):
                self._acked.setdefault(pod.uid, now)
                if pod.uid not in self.cluster.pod_scheduling_decisions:
                    undecided += 1
            # scheduling-decision latency (pod/controller.go:263): ack ->
            # first decision recorded in cluster state
            if (
                pod.uid in self._acked
                and pod.uid not in self._decided
                and (
                    pod.uid in self.cluster.pod_scheduling_decisions
                    or pod.node_name
                )
            ):
                self._decided.add(pod.uid)
                POD_SCHEDULING_DECISION.observe(
                    max(0.0, now - self._acked[pod.uid])
                )
            key = f"{pod.namespace}/{pod.name}"
            # bound family (recordPodBoundMetric)
            if pod.node_name:
                if pod.uid not in self._bound:
                    self._bound.add(pod.uid)
                    POD_BOUND_DURATION.observe(max(0.0, now - created))
            elif pod.phase == PodPhase.PENDING:
                self._unbound_store.update(key, [(labels, max(0.0, now - created))])
                live_waiting.add(("unbound", key))
            # startup family (recordPodStartupMetric)
            if pod.phase == PodPhase.RUNNING:
                if pod.uid not in self._started:
                    self._started.add(pod.uid)
                    POD_STARTUP.observe(max(0.0, now - created))
            elif pod.phase == PodPhase.PENDING:
                self._unstarted_store.update(
                    key, [(labels, max(0.0, now - created))]
                )
                live_waiting.add(("unstarted", key))
        # resolved/vanished waiting series GC through the stores
        for store, kind in (
            (self._unbound_store, "unbound"),
            (self._unstarted_store, "unstarted"),
        ):
            for key in list(store._owned):
                if (kind, key) not in live_waiting:
                    store.delete(key)
        # prune per-uid tracking for pods that no longer exist — a churning
        # cluster must not grow these maps without bound
        self._started &= live_uids
        self._bound &= live_uids
        self._decided &= live_uids
        for uid in list(self._acked):
            if uid not in live_uids:
                del self._acked[uid]
        for phase, n in counts.items():
            POD_STATE.set(float(n), {"phase": phase})
        POD_UNDECIDED.set(float(undecided))
