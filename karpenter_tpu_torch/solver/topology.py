"""Topology tracking: topology-spread constraints, pod affinity, pod
anti-affinity, and *inverse* anti-affinity.

Semantics ported from the reference:
- Topology           pkg/controllers/provisioning/scheduling/topology.go:47-583
- TopologyGroup      .../topologygroup.go:56-433
- TopologyNodeFilter .../topologynodefilter.go:31-97
- TopologyDomainGroup .../topologydomaingroup.go:28-72

A TopologyGroup tracks `SELECT COUNT(*) FROM pods GROUP BY(topology_key)` for
the pods matching one constraint; groups are deduplicated by a structural hash
so a 100-replica deployment with self anti-affinity is one group with 100
owners. The group answers "which domain may this pod pick next" — max-skew
argmin for spreads, non-empty domains for affinity, empty domains for
anti-affinity.
"""

from __future__ import annotations

import sys
from enum import IntEnum
from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    LabelSelector,
    LabelSelectorRequirement,
    NodeInclusionPolicy,
    Operator,
    Pod,
    PodAffinityTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WhenUnsatisfiable,
)
from karpenter_tpu_torch.scheduling import Requirement, Requirements, Taints

MAX_I32 = (1 << 31) - 1


class TopologyType(IntEnum):
    SPREAD = 0
    POD_AFFINITY = 1
    POD_ANTI_AFFINITY = 2

    def __str__(self) -> str:
        return ["topology spread", "pod affinity", "pod anti-affinity"][int(self)]


# ---------------------------------------------------------------------------
# node filter


def _selector_canonical(sel: Optional[LabelSelector]):
    if sel is None:
        return None
    return (
        frozenset(sel.match_labels.items()),
        frozenset(
            (e.key, e.operator, frozenset(e.values)) for e in sel.match_expressions
        ),
    )


def _requirements_canonical(reqs: Requirements):
    return frozenset(
        (r.key, r.complement, frozenset(r.values), r.greater_than, r.less_than)
        for r in reqs.values()
    )


class TopologyNodeFilter:
    """Decides if a node participates in a spread topology for counting
    purposes (reference topologynodefilter.go:31). A default-constructed
    filter matches everything (used for affinity/anti-affinity)."""

    def __init__(
        self,
        requirements: Optional[list[Requirements]] = None,
        taint_policy: NodeInclusionPolicy = NodeInclusionPolicy.IGNORE,
        affinity_policy: NodeInclusionPolicy = NodeInclusionPolicy.HONOR,
        tolerations: Optional[list[Toleration]] = None,
    ):
        self.requirements = requirements or []
        self.taint_policy = taint_policy
        self.affinity_policy = affinity_policy
        self.tolerations = tolerations or []

    @classmethod
    def for_pod(
        cls,
        pod: Pod,
        taint_policy: NodeInclusionPolicy,
        affinity_policy: NodeInclusionPolicy,
    ) -> "TopologyNodeFilter":
        """MakeTopologyNodeFilter: node selector AND any required node-affinity
        term (terms OR'd) (topologynodefilter.go:38)."""
        selector_reqs = Requirements.from_labels(pod.node_selector)
        affinity = pod.node_affinity
        if affinity is None or not affinity.required_terms:
            return cls([selector_reqs], taint_policy, affinity_policy, pod.tolerations)
        req_list = []
        for term in affinity.required_terms:
            reqs = Requirements()
            reqs.add(*selector_reqs.values())
            reqs.add(
                *(
                    Requirement.from_node_selector_requirement(e)
                    for e in term.match_expressions
                )
            )
            req_list.append(reqs)
        return cls(req_list, taint_policy, affinity_policy, pod.tolerations)

    def matches(
        self,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: Optional[set] = None,
    ) -> bool:
        matches_affinity = True
        if self.affinity_policy == NodeInclusionPolicy.HONOR and self.requirements:
            matches_affinity = any(
                requirements.compatible(req, allow_undefined) is None
                for req in self.requirements
            )
        matches_taints = True
        if self.taint_policy == NodeInclusionPolicy.HONOR:
            matches_taints = Taints(taints).tolerates(self.tolerations) is None
        return matches_affinity and matches_taints

    def canonical(self):
        return (
            self.taint_policy,
            self.affinity_policy,
            tuple(sorted(map(repr, map(_requirements_canonical, self.requirements)))),
            frozenset(self.tolerations) if self.taint_policy == NodeInclusionPolicy.HONOR else None,
        )


# ---------------------------------------------------------------------------
# domain groups


class TopologyDomainGroup(dict):
    """domain -> list of taint-sets under which the domain is reachable
    (reference topologydomaingroup.go:28)."""

    def insert(self, domain: str, taints: tuple[Taint, ...] = ()) -> None:
        groups = self.get(domain)
        if groups is None or len(taints) == 0:
            self[domain] = [tuple(taints)]
            return
        if len(groups[0]) == 0:
            return  # already reachable untainted
        groups.append(tuple(taints))

    def for_each_domain(
        self, pod: Pod, taint_policy: NodeInclusionPolicy, fn: Callable[[str], None]
    ) -> None:
        for domain, taint_groups in self.items():
            if taint_policy == NodeInclusionPolicy.IGNORE:
                fn(domain)
                continue
            for taints in taint_groups:
                if Taints(taints).tolerates_pod(pod) is None:
                    fn(domain)
                    break


def build_domain_groups(
    node_pools, instance_types_by_pool: dict
) -> dict[str, TopologyDomainGroup]:
    """Universe of domains per topology key = NodePool requirements+labels ∩
    instance-type requirements (reference topology.go:105 buildDomainGroups)."""
    pools_by_name = {np.name: np for np in node_pools}
    domain_groups: dict[str, TopologyDomainGroup] = {}
    for pool_name, its in instance_types_by_pool.items():
        np = pools_by_name[pool_name]
        taints = tuple(np.template.taints)
        base = Requirements.from_node_selector_requirements(np.template.requirements)
        base.add(*Requirements.from_labels(np.template.labels).values())
        for it in its:
            requirements = base.copy()
            requirements.add(*it.requirements.values())
            for key in requirements:
                group = domain_groups.setdefault(key, TopologyDomainGroup())
                for domain in requirements.get(key).values:
                    group.insert(domain, taints)
        for key in base:
            req = base.get(key)
            if req.operator() == Operator.IN:
                group = domain_groups.setdefault(key, TopologyDomainGroup())
                for domain in req.values:
                    group.insert(domain, taints)
    return domain_groups


# ---------------------------------------------------------------------------
# topology group


class TopologyGroup:
    """reference topologygroup.go:56."""

    def __init__(
        self,
        topology_type: TopologyType,
        key: str,
        pod: Pod,
        namespaces: frozenset[str],
        selector: Optional[LabelSelector],
        max_skew: int,
        min_domains: Optional[int],
        taint_policy: Optional[NodeInclusionPolicy],
        affinity_policy: Optional[NodeInclusionPolicy],
        domain_group: Optional[TopologyDomainGroup],
    ):
        self.type = topology_type
        self.key = key
        self.namespaces = namespaces
        self.selector = selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        if topology_type == TopologyType.SPREAD:
            self.node_filter = TopologyNodeFilter.for_pod(
                pod,
                taint_policy if taint_policy is not None else NodeInclusionPolicy.IGNORE,
                affinity_policy
                if affinity_policy is not None
                else NodeInclusionPolicy.HONOR,
            )
        else:
            self.node_filter = TopologyNodeFilter()  # always matches
        self.owners: set[str] = set()  # pod UIDs governed by this group
        self.domains: dict[str, int] = {}
        self.empty_domains: set[str] = set()
        if domain_group is not None:
            domain_group.for_each_domain(
                pod, self.node_filter.taint_policy, self._register_one
            )

    def _register_one(self, domain: str) -> None:
        if domain not in self.domains:
            self.domains[domain] = 0
            self.empty_domains.add(domain)

    # -- bookkeeping ------------------------------------------------------

    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1
            self.empty_domains.discard(d)

    def register(self, *domains: str) -> None:
        for d in domains:
            self._register_one(d)

    def unregister(self, *domains: str) -> None:
        for d in domains:
            self.domains.pop(d, None)
            self.empty_domains.discard(d)

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    def selects(self, pod: Pod) -> bool:
        return pod.namespace in self.namespaces and (
            self.selector is not None and self.selector.matches(pod.metadata.labels)
        )

    def counts(
        self,
        pod: Pod,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: Optional[set] = None,
    ) -> bool:
        """Would this pod count for the topology if scheduled on a node with
        these requirements (topologygroup.go:150)."""
        return self.selects(pod) and self.node_filter.matches(
            taints, requirements, allow_undefined
        )

    def hash_key(self):
        """Structural identity for dedup (topologygroup.go:186 Hash). Unlike
        the reference we also include minDomains — two constraints differing
        only there should not share counts."""
        return (
            self.key,
            self.type,
            self.namespaces,
            self.max_skew,
            self.min_domains,
            self.node_filter.canonical(),
            _selector_canonical(self.selector),
        )

    # -- domain selection ---------------------------------------------------

    def get(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        if self.type == TopologyType.SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TopologyType.POD_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains, node_domains)

    def _next_domain_spread(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """topologygroup.go:226 nextDomainTopologySpread — pick the min-count
        node-reachable domain within maxSkew of the global min."""
        min_count = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)

        # hostname special case: a new NodeClaim's hostname domain isn't
        # registered yet; global min is always 0 since we can mint a new node.
        # (Guarded to concrete In values; for complements .values holds the
        # *excluded* set.)
        if (
            self.key == well_known.HOSTNAME_LABEL_KEY
            and not node_domains.complement
            and len(node_domains.values) == 1
        ):
            hostname = next(iter(node_domains.values))
            count = self.domains.get(hostname, 0)
            if self_selecting:
                count += 1
            if count <= self.max_skew:
                return Requirement(self.key, Operator.IN, [hostname])
            return Requirement(self.key, Operator.DOES_NOT_EXIST)

        # Deterministic tie-break: the reference iterates Go maps (randomized
        # per iteration), so ties are unspecified there. We determinize to
        # sorted order; the TPU kernel assigns vocab ids in sorted order so the
        # two agree bit-for-bit.
        best_domain = None
        best_count = MAX_I32
        if node_domains.operator() == Operator.IN:
            candidates = (d for d in sorted(node_domains.values) if d in self.domains)
        else:
            candidates = (d for d in sorted(self.domains) if node_domains.has(d))
        for domain in candidates:
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - min_count <= self.max_skew and count < best_count:
                best_domain = domain
                best_count = count
        if best_domain is None:
            return Requirement(self.key, Operator.DOES_NOT_EXIST)
        return Requirement(self.key, Operator.IN, [best_domain])

    def _domain_min_count(self, pod_domains: Requirement) -> int:
        """topologygroup.go:289 domainMinCount."""
        if self.key == well_known.HOSTNAME_LABEL_KEY:
            return 0
        min_count = MAX_I32
        supported = 0
        for domain, count in self.domains.items():
            if pod_domains.has(domain):
                supported += 1
                if count < min_count:
                    min_count = count
        if self.min_domains is not None and supported < self.min_domains:
            min_count = 0
        return min_count

    def _next_domain_affinity(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """topologygroup.go:313 nextDomainAffinity."""
        options = Requirement(self.key, Operator.DOES_NOT_EXIST)

        if (
            self.key == well_known.HOSTNAME_LABEL_KEY
            and not node_domains.complement
            and len(node_domains.values) == 1
        ):
            hostname = next(iter(node_domains.values))
            if not pod_domains.has(hostname):
                return options
            if self.domains.get(hostname, 0) > 0:
                options.values.add(hostname)
                return options
            if self.selects(pod) and (
                len(self.domains) == len(self.empty_domains)
                or not self._any_compatible_pod_domain(pod_domains)
            ):
                options.values.add(hostname)
            return options

        if node_domains.operator() == Operator.IN:
            for domain in node_domains.values:
                if (
                    pod_domains.has(domain)
                    and self.domains.get(domain, 0) > 0
                ):
                    options.values.add(domain)
        else:
            for domain, count in self.domains.items():
                if pod_domains.has(domain) and count > 0 and node_domains.has(domain):
                    options.values.add(domain)
        if options.values:
            return options

        # bootstrap: self-selecting pod and either nothing scheduled yet or the
        # scheduled pods are incompatible with our pod domains
        if self.selects(pod) and (
            len(self.domains) == len(self.empty_domains)
            or not self._any_compatible_pod_domain(pod_domains)
        ):
            intersected = pod_domains.intersection(node_domains)
            for domain in sorted(self.domains):  # determinized (see spread)
                if intersected.has(domain):
                    options.values.add(domain)
                    break
            if not options.values:
                for domain in sorted(self.domains):
                    if pod_domains.has(domain):
                        options.values.add(domain)
                        break
        return options

    def _any_compatible_pod_domain(self, pod_domains: Requirement) -> bool:
        return any(
            pod_domains.has(d) and c > 0 for d, c in self.domains.items()
        )

    def _next_domain_anti_affinity(
        self, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """topologygroup.go:393 nextDomainAntiAffinity — only empty domains."""
        options = Requirement(self.key, Operator.DOES_NOT_EXIST)
        if (
            self.key == well_known.HOSTNAME_LABEL_KEY
            and not node_domains.complement
            and len(node_domains.values) == 1
        ):
            hostname = next(iter(node_domains.values))
            if self.domains.get(hostname, 0) == 0:
                options.values.add(hostname)
            return options
        if (
            node_domains.operator() == Operator.IN
            and len(node_domains.values) < len(self.empty_domains)
        ):
            for domain in node_domains.values:
                if domain in self.empty_domains and pod_domains.has(domain):
                    options.values.add(domain)
        else:
            for domain in self.empty_domains:
                if node_domains.has(domain) and pod_domains.has(domain):
                    options.values.add(domain)
        return options


# ---------------------------------------------------------------------------
# cluster view for domain counting


class ClusterSource:
    """The slice of cluster state topology counting needs: existing scheduled
    pods (with their nodes) and node label/taint views. The control plane
    passes its state cache; benchmarks pass nothing (reference topology.go
    gets this from the kube client + state nodes)."""

    def __init__(
        self,
        pods_by_namespace: Optional[dict[str, list[Pod]]] = None,
        nodes_by_name: Optional[dict] = None,
        namespace_labels: Optional[dict[str, dict[str, str]]] = None,
    ):
        self.pods_by_namespace = pods_by_namespace or {}
        self.nodes_by_name = nodes_by_name or {}
        # namespace name -> labels, for namespaceSelector resolution
        self.namespace_labels = namespace_labels or {}

    def list_pods(self, namespace: str) -> list[Pod]:
        return self.pods_by_namespace.get(namespace, [])

    def get_node(self, name: str):
        return self.nodes_by_name.get(name)

    def pods_with_anti_affinity(self):
        for pods in self.pods_by_namespace.values():
            for p in pods:
                if p.pod_anti_affinity and p.node_name:
                    node = self.get_node(p.node_name)
                    if node is not None:
                        yield p, node


# ---------------------------------------------------------------------------
# Topology


class Topology:
    """reference topology.go:47."""

    def __init__(
        self,
        node_pools,
        instance_types_by_pool: dict,
        pods: list[Pod],
        cluster: Optional[ClusterSource] = None,
        state_node_views: Optional[list] = None,
        ignore_preferences: bool = False,
    ):
        self.cluster = cluster or ClusterSource()
        self.ignore_preferences = ignore_preferences
        self.domain_groups = build_domain_groups(node_pools, instance_types_by_pool)
        self.topology_groups: dict = {}
        self.inverse_topology_groups: dict = {}
        self.excluded_pods: set[str] = {p.uid for p in pods}
        # The namespace universe for namespaceSelector resolution: explicit
        # Namespace objects plus namespaces that exist implicitly because a
        # pod lives in them (in real Kubernetes the Namespace object always
        # exists; a sim need not create one). Implicit namespaces carry no
        # labels, so an empty match-all selector still finds them while a
        # label-matched selector correctly does not.
        self._namespace_universe: dict[str, dict[str, str]] = dict(
            self.cluster.namespace_labels
        )
        for ns in self.cluster.pods_by_namespace:
            self._namespace_universe.setdefault(ns, {})
        for p in pods:
            self._namespace_universe.setdefault(p.namespace, {})
        self._namespace_list_cache: dict = {}
        # label views of real nodes so countDomains can capture domains that
        # exist only on live nodes (topology.go:345-362)
        self.state_node_views = state_node_views or []

        for p, node in self.cluster.pods_with_anti_affinity():
            if p.uid in self.excluded_pods:
                continue
            self._update_inverse_anti_affinity(p, node.metadata.labels)
        for p in pods:
            self.update(p)

    # -- group construction -------------------------------------------------

    def update(self, pod: Pod) -> None:
        """(Re-)register the pod as owner of the topologies its current spec
        implies; called after relaxation to drop preferred constraints
        (topology.go:162 Update)."""
        for tg in self.topology_groups.values():
            tg.remove_owner(pod.uid)

        has_required_anti = bool(pod.pod_anti_affinity)
        has_any_anti = has_required_anti or bool(pod.pod_anti_affinity_preferred)
        if (self.ignore_preferences and has_required_anti) or (
            not self.ignore_preferences and has_any_anti
        ):
            self._update_inverse_anti_affinity(pod, None)

        groups = self._new_for_topologies(pod) + self._new_for_affinities(pod)
        for tg in groups:
            key = tg.hash_key()
            existing = self.topology_groups.get(key)
            if existing is None:
                self._count_domains(tg)
                self.topology_groups[key] = tg
                existing = tg
            existing.add_owner(pod.uid)

    def _build_namespace_list(
        self, pod_namespace: str, term: PodAffinityTerm
    ) -> frozenset[str]:
        """topology.go:503 buildNamespaceList: no namespaces and no selector
        -> the pod's namespace; explicit list without selector -> that list;
        a selector unions label-matched namespaces with the explicit list."""
        selector = getattr(term, "namespace_selector", None)
        if not term.namespaces and selector is None:
            return frozenset({pod_namespace})
        if selector is None:
            return frozenset(term.namespaces)
        # memoized per (selector, explicit list): identical replicas of one
        # deployment would otherwise rescan the namespace universe N times
        from karpenter_tpu_torch.solver.ordering import _selector_key

        key = (_selector_key(selector), tuple(sorted(term.namespaces)))
        got = self._namespace_list_cache.get(key)
        if got is None:
            selected = {
                name
                for name, labels in self._namespace_universe.items()
                if selector.matches(labels)
            }
            selected.update(term.namespaces)
            got = frozenset(selected)
            self._namespace_list_cache[key] = got
        return got

    def _new_for_topologies(self, pod: Pod) -> list[TopologyGroup]:
        groups = []
        for tsc in pod.topology_spread_constraints:
            if (
                self.ignore_preferences
                and tsc.when_unsatisfiable != WhenUnsatisfiable.DO_NOT_SCHEDULE
            ):
                continue
            selector = tsc.label_selector
            if tsc.match_label_keys:
                # topology.go:434: fold the pod's own values for each
                # matchLabelKeys entry into the selector as In expressions,
                # scoping the spread to pods sharing those values (e.g. one
                # group per deployment revision)
                extra = [
                    LabelSelectorRequirement(
                        key=k, operator=Operator.IN, values=[pod.metadata.labels[k]]
                    )
                    for k in tsc.match_label_keys
                    if k in pod.metadata.labels
                ]
                if extra:
                    selector = LabelSelector(
                        match_labels=dict(selector.match_labels)
                        if selector
                        else {},
                        match_expressions=(
                            list(selector.match_expressions) if selector else []
                        )
                        + extra,
                    )
            groups.append(
                TopologyGroup(
                    TopologyType.SPREAD,
                    tsc.topology_key,
                    pod,
                    frozenset({pod.namespace}),
                    selector,
                    tsc.max_skew,
                    tsc.min_domains,
                    tsc.node_taints_policy,
                    tsc.node_affinity_policy,
                    self.domain_groups.get(tsc.topology_key),
                )
            )
        return groups

    def _new_for_affinities(self, pod: Pod) -> list[TopologyGroup]:
        groups = []
        terms: list[tuple[TopologyType, PodAffinityTerm]] = [
            (TopologyType.POD_AFFINITY, t) for t in pod.pod_affinity
        ]
        if not self.ignore_preferences:
            terms += [
                (TopologyType.POD_AFFINITY, w.term) for w in pod.pod_affinity_preferred
            ]
        terms += [(TopologyType.POD_ANTI_AFFINITY, t) for t in pod.pod_anti_affinity]
        if not self.ignore_preferences:
            terms += [
                (TopologyType.POD_ANTI_AFFINITY, w.term)
                for w in pod.pod_anti_affinity_preferred
            ]
        for topology_type, term in terms:
            namespaces = self._build_namespace_list(pod.namespace, term)
            groups.append(
                TopologyGroup(
                    topology_type,
                    term.topology_key,
                    pod,
                    namespaces,
                    term.label_selector,
                    MAX_I32,
                    None,
                    None,
                    None,
                    self.domain_groups.get(term.topology_key),
                )
            )
        return groups

    def _update_inverse_anti_affinity(
        self, pod: Pod, node_labels: Optional[dict]
    ) -> None:
        """Track pods with anti-affinity so we can avoid scheduling their
        targets near them (topology.go:297). Only required terms."""
        for term in pod.pod_anti_affinity:
            namespaces = self._build_namespace_list(pod.namespace, term)
            tg = TopologyGroup(
                TopologyType.POD_ANTI_AFFINITY,
                term.topology_key,
                pod,
                namespaces,
                term.label_selector,
                MAX_I32,
                None,
                None,
                None,
                self.domain_groups.get(term.topology_key),
            )
            key = tg.hash_key()
            existing = self.inverse_topology_groups.get(key)
            if existing is None:
                self.inverse_topology_groups[key] = tg
            else:
                tg = existing
            if node_labels and tg.key in node_labels:
                tg.record(node_labels[tg.key])
            tg.add_owner(pod.uid)

    def _count_domains(self, tg: TopologyGroup) -> None:
        """Seed a new group with existing-cluster pod counts
        (topology.go:328 countDomains)."""
        # capture domains only present on live nodes
        for view in self.state_node_views:
            if view.node_labels is None:
                continue
            if not tg.node_filter.matches(
                view.taints, Requirements.from_labels(view.node_labels)
            ):
                continue
            domain = view.node_labels.get(tg.key)
            if domain is not None:
                tg.register(domain)

        for namespace in tg.namespaces:
            for p in self.cluster.list_pods(namespace):
                if not p.node_name or p.phase in ("Succeeded", "Failed") or p.terminating:
                    continue
                if p.uid in self.excluded_pods:
                    continue
                if tg.selector is None or not tg.selector.matches(p.metadata.labels):
                    continue
                node = self.cluster.get_node(p.node_name)
                if node is None:
                    continue
                domain = node.metadata.labels.get(tg.key)
                if domain is None and tg.key == well_known.HOSTNAME_LABEL_KEY:
                    domain = node.name
                if domain is None:
                    continue
                if not tg.node_filter.matches(
                    node.taints, Requirements.from_labels(node.metadata.labels)
                ):
                    continue
                tg.record(domain)

    # -- solve-time interface -------------------------------------------------

    def add_requirements(
        self,
        pod: Pod,
        taints: Iterable[Taint],
        pod_requirements: Requirements,
        node_requirements: Requirements,
        allow_undefined: Optional[set] = None,
    ) -> tuple[Optional[Requirements], Optional[str]]:
        """Tighten node requirements with the next viable domain per matching
        topology (topology.go:226 AddRequirements). Returns (requirements,
        error)."""
        requirements = Requirements(node_requirements.values())
        for tg in self._matching_topologies(pod, taints, node_requirements, allow_undefined):
            pod_domains = (
                pod_requirements.get(tg.key)
                if pod_requirements.has(tg.key)
                else Requirement(tg.key, Operator.EXISTS)
            )
            node_domains = (
                node_requirements.get(tg.key)
                if node_requirements.has(tg.key)
                else Requirement(tg.key, Operator.EXISTS)
            )
            domains = tg.get(pod, pod_domains, node_domains)
            if len(domains) == 0:
                counts = dict(sorted(tg.domains.items())[:25])
                return None, (
                    f"unsatisfiable topology constraint for {tg.type}, key={tg.key} "
                    f"(counts = {counts}, podDomains = {pod_domains!r}, "
                    f"nodeDomains = {node_domains!r})"
                )
            requirements.add(domains)
        return requirements, None

    def record(
        self,
        pod: Pod,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: Optional[set] = None,
    ) -> None:
        """Commit domain counts after a pod lands (topology.go:197 Record)."""
        for tg in self.topology_groups.values():
            if tg.counts(pod, taints, requirements, allow_undefined):
                domains = requirements.get(tg.key)
                if tg.type == TopologyType.POD_ANTI_AFFINITY:
                    tg.record(*domains.values)
                elif len(domains) == 1:
                    tg.record(next(iter(domains.values)))
        for tg in self.inverse_topology_groups.values():
            if tg.is_owned_by(pod.uid):
                tg.record(*requirements.get(tg.key).values)

    def register(self, topology_key: str, domain: str) -> None:
        for tg in self.topology_groups.values():
            if tg.key == topology_key:
                tg.register(domain)
        for tg in self.inverse_topology_groups.values():
            if tg.key == topology_key:
                tg.register(domain)

    def unregister(self, topology_key: str, domain: str) -> None:
        for tg in self.topology_groups.values():
            if tg.key == topology_key:
                tg.unregister(domain)
        for tg in self.inverse_topology_groups.values():
            if tg.key == topology_key:
                tg.unregister(domain)

    def _matching_topologies(
        self,
        pod: Pod,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: Optional[set],
    ) -> list[TopologyGroup]:
        """Groups owning the pod + inverse groups whose owners' anti-affinity
        selects the pod (topology.go:528 getMatchingTopologies)."""
        out = [
            tg for tg in self.topology_groups.values() if tg.is_owned_by(pod.uid)
        ]
        out += [
            tg
            for tg in self.inverse_topology_groups.values()
            if tg.counts(pod, taints, requirements, allow_undefined)
        ]
        return out
