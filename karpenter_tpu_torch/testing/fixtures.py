"""Object factories and benchmark workload generators.

The factories mirror the reference's test fixture package
(pkg/test/pods.go et al.); the pod-mix generators replicate the
scheduling benchmark harness exactly — same five pod classes, same discrete
CPU/memory/label-value distributions — so throughput numbers are comparable
with the reference benchmark
(pkg/controllers/provisioning/scheduling/
scheduling_benchmark_test.go:257-453).
"""

from __future__ import annotations

import random
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    Budget,
    Container,
    Disruption,
    LabelSelector,
    NodeAffinity,
    NodeClaimTemplateSpec,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Operator,
    Pod,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    NodePool,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    WhenUnsatisfiable,
)
from karpenter_tpu_torch.utils import resources as res

# Seeded like the reference benchmark (scheduling_benchmark_test.go:62)
_rng = random.Random(42)


def reset_rng(seed: int = 42) -> None:
    global _rng
    _rng = random.Random(seed)


# ---------------------------------------------------------------------------
# factories


def pod(
    name: str = "",
    namespace: str = "default",
    labels: Optional[dict[str, str]] = None,
    requests: Optional[dict[str, str | int]] = None,
    node_selector: Optional[dict[str, str]] = None,
    node_requirements: Optional[list[NodeSelectorRequirement]] = None,
    node_preferences: Optional[list[NodeSelectorRequirement]] = None,
    pod_requirements: Optional[list[PodAffinityTerm]] = None,
    pod_preferences: Optional[list[WeightedPodAffinityTerm]] = None,
    pod_anti_requirements: Optional[list[PodAffinityTerm]] = None,
    pod_anti_preferences: Optional[list[WeightedPodAffinityTerm]] = None,
    topology_spread_constraints: Optional[list[TopologySpreadConstraint]] = None,
    tolerations: Optional[list[Toleration]] = None,
    creation_timestamp: float = 0.0,
    init_containers: Optional[list[Container]] = None,
    overhead: Optional[dict[str, str | int]] = None,
) -> Pod:
    """test.Pod(test.PodOptions{...}) equivalent (reference pkg/test/pods.go).

    `requests` are the MAIN container's requests; when `init_containers`
    or `overhead` are given, the pod's effective requests resolve via the
    Ceiling rule at construction (reference test.UnschedulablePod with
    InitContainers/Overhead options, suite_test.go:1515)."""
    meta = ObjectMeta(
        name=name or f"pod-{ObjectMeta().uid[:8]}",
        namespace=namespace,
        labels=dict(labels or {}),
        creation_timestamp=creation_timestamp,
    )
    node_affinity = None
    if node_requirements or node_preferences:
        node_affinity = NodeAffinity(
            required_terms=(
                [NodeSelectorTerm(list(node_requirements))] if node_requirements else []
            ),
            preferred=(
                [
                    PreferredSchedulingTerm(weight=10, preference=NodeSelectorTerm([p]))
                    for p in node_preferences
                ]
                if node_preferences
                else []
            ),
        )
    parsed_requests = res.parse_list(requests or {})
    containers: list[Container] = []
    if init_containers or overhead:
        # route through the Ceiling path: the main requests become the
        # single app container, Pod.__post_init__ resolves the effective
        # pod-level requests
        containers = [Container(requests=parsed_requests)] if parsed_requests else []
        parsed_requests = {}
    return Pod(
        metadata=meta,
        requests=parsed_requests,
        containers=containers,
        init_containers=list(init_containers or []),
        overhead=res.parse_list(overhead or {}),
        node_selector=dict(node_selector or {}),
        node_affinity=node_affinity,
        pod_affinity=list(pod_requirements or []),
        pod_affinity_preferred=list(pod_preferences or []),
        pod_anti_affinity=list(pod_anti_requirements or []),
        pod_anti_affinity_preferred=list(pod_anti_preferences or []),
        tolerations=list(tolerations or []),
        topology_spread_constraints=list(topology_spread_constraints or []),
    )


def container(
    requests: Optional[dict[str, str | int]] = None,
    limits: Optional[dict[str, str | int]] = None,
    restart_policy: Optional[str] = None,
) -> Container:
    """v1.Container fixture for init-container/sidecar binpacking tests."""
    return Container(
        requests=res.parse_list(requests or {}),
        limits=res.parse_list(limits or {}),
        restart_policy=restart_policy,
    )


def node_pool(
    name: str = "default",
    requirements: Optional[list[NodeSelectorRequirement]] = None,
    labels: Optional[dict[str, str]] = None,
    taints: Optional[list[Taint]] = None,
    startup_taints: Optional[list[Taint]] = None,
    limits: Optional[dict[str, str | int]] = None,
    weight: int = 0,
    consolidate_after_seconds: float = 0.0,
    budgets: Optional[list[Budget]] = None,
    replicas: Optional[int] = None,
) -> NodePool:
    """test.NodePool equivalent: defaults mirror pkg/test/nodepool.go (default
    requirements allow linux + amd64/arm64 + on-demand/spot)."""
    reqs = requirements if requirements is not None else []
    return NodePool(
        metadata=ObjectMeta(name=name),
        template=NodeClaimTemplateSpec(
            requirements=list(reqs),
            labels=dict(labels or {}),
            taints=list(taints or []),
            startup_taints=list(startup_taints or []),
        ),
        disruption=Disruption(
            consolidate_after_seconds=consolidate_after_seconds,
            budgets=budgets if budgets is not None else [Budget(nodes="10%")],
        ),
        limits=res.parse_list(limits or {}),
        weight=weight,
        replicas=replicas,
    )


# ---------------------------------------------------------------------------
# benchmark pod mixes (scheduling_benchmark_test.go:257-453)

_LABEL_VALUES = ["a", "b", "c", "d", "e", "f", "g"]
_MEM_CHOICES = [100, 256, 512, 1024, 2048, 4096]  # Mi
_CPU_CHOICES = [100, 250, 500, 1000, 1500]  # m


def _random_labels() -> dict[str, str]:
    return {"my-label": _rng.choice(_LABEL_VALUES)}


def _random_affinity_labels() -> dict[str, str]:
    return {"my-affininity": _rng.choice(_LABEL_VALUES)}  # [sic] reference typo


def _random_requests() -> dict[str, str]:
    return {
        res.CPU: f"{_rng.choice(_CPU_CHOICES)}m",
        res.MEMORY: f"{_rng.choice(_MEM_CHOICES)}Mi",
    }


def make_generic_pods(count: int) -> list[Pod]:
    return [
        pod(name=f"generic-{i}", labels=_random_labels(), requests=_random_requests())
        for i in range(count)
    ]


def make_topology_spread_pods(count: int, key: str) -> list[Pod]:
    return [
        pod(
            name=f"tsc-{key.rsplit('/', 1)[-1]}-{i}",
            labels=_random_labels(),
            requests=_random_requests(),
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=key,
                    when_unsatisfiable=WhenUnsatisfiable.DO_NOT_SCHEDULE,
                    label_selector=LabelSelector(match_labels=_random_labels()),
                )
            ],
        )
        for i in range(count)
    ]


def make_self_spread_pods(count: int, cpu: str = "100m") -> list[Pod]:
    """Self-selecting zone-spread pods: every pod carries a DO_NOT_
    SCHEDULE zone spread whose selector matches its own (shared) labels.
    This is the dynamic-topology shape that forces the exact per-pod
    SCAN path (tpu.py _bulk_class_flags: self-selecting zone-family
    spread counts move mid-run), which is the only path the fleet
    coalescer serves — the ONE fixture behind tests/test_fleet.py,
    the fault suite's fleet lanes, analysis/ir.py's fleet[runtime]
    kit, and bench.py --fleet, so what forces the scan path is defined
    in exactly one place. `cpu` varies the request profile per lane
    WITHOUT touching the requirement classes (keep it a multiple of
    100m: request granularity feeds the resource-table scale, which is
    shared-Tables content the fleet fingerprint correctly refuses to
    stack across)."""
    labels = {"app": "fleet"}
    return [
        pod(
            name=f"sp-{i}",
            labels=dict(labels),
            requests={"cpu": cpu},
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    when_unsatisfiable=WhenUnsatisfiable.DO_NOT_SCHEDULE,
                    label_selector=LabelSelector(match_labels=dict(labels)),
                )
            ],
        )
        for i in range(count)
    ]


def make_follower_pods(count: int, cpu: str = "1") -> list[Pod]:
    """Pods that must share a zone with make_self_spread_pods' pods (a
    required zone affinity to app=fleet) and spread over zones themselves.
    They ask more cpu, so FFD orders them first: in a solve's first round
    no app=fleet pod is placed yet and each fails (they do not match their
    own affinity, so nothing bootstraps), and the next round places them
    beside the spread pods. Their self-selecting spread keeps the whole
    problem on the scan path, so a fleet window's lanes requeue."""
    labels = {"app": "follower"}
    return [
        pod(
            name=f"follow-{i}",
            labels=dict(labels),
            requests={"cpu": cpu},
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    when_unsatisfiable=WhenUnsatisfiable.DO_NOT_SCHEDULE,
                    label_selector=LabelSelector(match_labels=dict(labels)),
                )
            ],
            pod_requirements=[
                PodAffinityTerm(
                    topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                    label_selector=LabelSelector(match_labels={"app": "fleet"}),
                )
            ],
        )
        for i in range(count)
    ]


def make_pod_affinity_pods(count: int, key: str) -> list[Pod]:
    out = []
    for i in range(count):
        # self-affinity, as in the reference (benchmark_test.go:300-327)
        labels = _random_affinity_labels()
        out.append(
            pod(
                name=f"aff-{i}",
                labels=labels,
                requests=_random_requests(),
                pod_requirements=[
                    PodAffinityTerm(
                        topology_key=key,
                        label_selector=LabelSelector(match_labels=dict(labels)),
                    )
                ],
            )
        )
    return out


def make_pod_anti_affinity_pods(count: int, key: str) -> list[Pod]:
    # all of these pods have anti-affinity to each other
    labels = {"app": "nginx"}
    return [
        pod(
            name=f"anti-{i}",
            labels=dict(labels),
            requests=_random_requests(),
            pod_anti_requirements=[
                PodAffinityTerm(
                    topology_key=key,
                    label_selector=LabelSelector(match_labels=dict(labels)),
                )
            ],
        )
        for i in range(count)
    ]


def make_diverse_pods(count: int) -> list[Pod]:
    """makeDiversePods: five equal classes — generic, zonal TSC, hostname TSC,
    zonal self-affinity, hostname anti-affinity — padded with generics."""
    n = count // 5
    pods: list[Pod] = []
    pods += make_generic_pods(n)
    pods += make_topology_spread_pods(n, well_known.TOPOLOGY_ZONE_LABEL_KEY)
    pods += make_topology_spread_pods(n, well_known.HOSTNAME_LABEL_KEY)
    pods += make_pod_affinity_pods(n, well_known.TOPOLOGY_ZONE_LABEL_KEY)
    pods += make_pod_anti_affinity_pods(n, well_known.HOSTNAME_LABEL_KEY)
    pods += make_generic_pods(count - len(pods))
    return pods


def make_preference_pods(count: int) -> list[Pod]:
    """makePreferencePods: one satisfiable node preference + one unsatisfiable
    and one satisfiable pod-anti preference (benchmark_test.go:378-426)."""
    out = []
    for i in range(count):
        out.append(
            pod(
                name=f"pref-{i}",
                labels={"app": "nginx"},
                requests=_random_requests(),
                node_preferences=[
                    NodeSelectorRequirement(
                        well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, ["test-zone-1"]
                    )
                ],
                pod_anti_preferences=[
                    WeightedPodAffinityTerm(
                        weight=10,
                        term=PodAffinityTerm(
                            topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                            label_selector=LabelSelector(match_labels={"app": "nginx"}),
                        ),
                    ),
                    WeightedPodAffinityTerm(
                        weight=1,
                        term=PodAffinityTerm(
                            topology_key=well_known.HOSTNAME_LABEL_KEY,
                            label_selector=LabelSelector(match_labels={"app": "nginx"}),
                        ),
                    ),
                ],
            )
        )
    return out



# ---------------------------------------------------------------------------
# consolidation fleets


# seeds per oracle solve in underutilized_world
_SEED_CHUNK = 64


def underutilized_world(
    n_nodes: int,
    *,
    seed: int = 7,
    sizes: Optional[list[int]] = None,
    rider_requests=None,
    seed_requests=None,
    n_pending: int = 0,
    pending_requests=None,
    rider_spread: Optional[int] = None,
    heavy_every: Optional[int] = None,
    heavy_requests=None,
):
    """An under-utilized fleet without the control plane: the counterpart
    of the reference's `underutilized_operator` (and its
    `make_underutilized_fleet`), built directly on the port's API store.

    `n_nodes` seed pods with hostname anti-affinity (seed_requests, default
    700m / 512Mi) are solved by the port's oracle `Scheduler` against a
    default NodePool (100% disruption budget) and the KWOK types (`sizes`
    as construct_instance_types takes them). Each new claim launches
    through the KWOK provider's `create` (the cheapest compatible
    offering), and its Node registers and initializes as the lifecycle
    controller would make it. Each seed is then swapped for a small bound
    RUNNING rider (rider_requests, default 100m / 128Mi) on its node, and
    the claims are marked consolidatable. `n_pending` unbound pods
    (pending_requests, default 250m / 256Mi) wait for the next solve.
    `rider_spread` gives every rider a zone topology spread with that
    max skew (DoNotSchedule, over the riders). With `heavy_every`, the node
    of every seed i with i % heavy_every == 1 holds a bound pod of
    heavy_requests (`heavy-<i>`, label fleet=heavy) instead of its rider:
    a second pod class, which the sweeps order first when it asks more
    cpu, and which no instance type may fit.

    Returns a convert.World (kube, cluster, clock, cloud)."""
    from karpenter_tpu_torch.api.objects import (
        COND_CONSOLIDATABLE,
        COND_INITIALIZED,
        COND_LAUNCHED,
        COND_REGISTERED,
        PodPhase,
    )
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider, construct_instance_types
    from karpenter_tpu_torch.controllers.kube import FakeClock, SimKube
    from karpenter_tpu_torch.controllers.state import UNREGISTERED_TAINT, Cluster, wire_informers
    from karpenter_tpu_torch.convert import World
    from karpenter_tpu_torch.solver.oracle import Scheduler, SchedulerOptions
    from karpenter_tpu_torch.solver.topology import Topology

    clock = FakeClock()
    kube = SimKube(clock)
    cluster = Cluster(clock)
    wire_informers(kube, cluster)
    cloud = KwokCloudProvider(
        kube, clock, instance_types=construct_instance_types(sizes=sizes) if sizes is not None else None
    )
    reset_rng(seed)
    pool = kube.create("NodePool", node_pool(name="default", budgets=[Budget(nodes="100%")]))

    seeds = [
        pod(
            name=f"seed-{i}",
            labels={"fleet": "seed"},
            requests=dict(seed_requests or {"cpu": "700m", "memory": "512Mi"}),
            pod_anti_requirements=[
                PodAffinityTerm(
                    topology_key=well_known.HOSTNAME_LABEL_KEY,
                    label_selector=LabelSelector(match_labels={"fleet": "seed"}),
                )
            ],
        )
        for i in range(n_nodes)
    ]
    # The anti-affinity puts every seed on a claim of its own, so solving
    # the seeds in chunks gives the claims one solve would, at a cost
    # linear in the fleet (one solve is quadratic: each seed screens every
    # claim opened before it).
    its_by_pool = {pool.name: cloud.get_instance_types(pool)}
    claims = []
    for lo in range(0, n_nodes, _SEED_CHUNK):
        chunk = seeds[lo : lo + _SEED_CHUNK]
        topology = Topology([pool], its_by_pool, chunk, state_node_views=[])
        results = Scheduler([pool], its_by_pool, topology, [], [], SchedulerOptions()).solve(chunk)
        opened = [c for c in results.new_node_claims if c.pods]
        if results.pod_errors or len(opened) < len(chunk):
            raise RuntimeError(f"fleet setup: {len(results.pod_errors)} seeds unplaced")
        claims += opened

    node_of_seed = {}
    clock.advance(2.0)
    for k, claim in enumerate(claims, start=1):
        nc = claim.to_node_claim()
        nc.metadata.name = f"{claim.nodepool_name}-{k:05d}"
        nc.metadata.finalizers.append(well_known.TERMINATION_FINALIZER)
        launched = cloud.create(nc)
        # lifecycle launch: the provider's status and labels, then the
        # claim's single-value requirements, then its own labels
        nc.status = launched.status
        labels = dict(launched.metadata.labels)
        for r in nc.requirements:
            if r.operator == "In" and len(r.values) == 1:
                labels[r.key] = r.values[0]
        labels.update(nc.metadata.labels)
        nc.metadata.labels = labels
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED, COND_CONSOLIDATABLE):
            nc.status.conditions[cond] = "True"
        kube.create("NodeClaim", nc)
        # registration and initialization of the node the provider made
        node = cloud._pending_nodes.pop()[1]
        node.metadata.labels.update(labels)
        node.metadata.labels[well_known.NODE_REGISTERED_LABEL_KEY] = "true"
        node.metadata.labels[well_known.NODE_INITIALIZED_LABEL_KEY] = "true"
        node.taints = [t for t in node.taints if t != UNREGISTERED_TAINT]
        kube.create("Node", node)
        for p in claim.pods:
            node_of_seed[p.name] = node.name

    clock.advance(2.0)
    spread = []
    if rider_spread is not None:
        spread = [
            TopologySpreadConstraint(
                max_skew=rider_spread,
                topology_key=well_known.TOPOLOGY_ZONE_LABEL_KEY,
                label_selector=LabelSelector(match_labels={"fleet": "rider"}),
            )
        ]
    for i in range(n_nodes):
        heavy = heavy_every is not None and i % heavy_every == 1
        rider = pod(
            name=f"heavy-{i}" if heavy else f"rider-{i}",
            labels={"fleet": "heavy" if heavy else "rider"},
            requests=dict(heavy_requests if heavy else rider_requests or {"cpu": "100m", "memory": "128Mi"}),
            topology_spread_constraints=[] if heavy else spread,
        )
        rider.node_name = node_of_seed[f"seed-{i}"]
        rider.phase = PodPhase.RUNNING
        kube.create("Pod", rider)
    for i in range(n_pending):
        kube.create(
            "Pod",
            pod(
                name=f"pending-{i}",
                labels={"fleet": "pending"},
                requests=dict(pending_requests or {"cpu": "250m", "memory": "256Mi"}),
            ),
        )
    clock.advance(30.0)
    return World(kube, cluster, clock, cloud)
