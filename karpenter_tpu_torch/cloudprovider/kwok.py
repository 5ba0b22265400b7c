"""KWOK-style simulated cloud: a generated instance-type universe and (in
karpenter_tpu.controllers) a provider that fabricates Node objects directly —
no kubelet, no cloud API — so the full provision->schedule->consolidate loop
runs self-contained (reference kwok/ and
designs/kwok-provider.md).

Universe: 12 sizes x 3 families x 2 OS x 2 arch = 288 instance types, each
offered in 4 zones x {spot, on-demand} (kwok/tools/gen_instance_types.go:70-110).
Pricing: base = vCPU*0.025 + GiB*0.001, spot = 0.7x (designs/kwok-provider.md:44-56).
"""

from __future__ import annotations

import itertools
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import Operator
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    InstanceTypes,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling import Requirement, Requirements
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.quantity import parse as q

KWOK_GROUP = "karpenter.kwok.sh"
INSTANCE_SIZE_LABEL_KEY = f"{KWOK_GROUP}/instance-size"
INSTANCE_FAMILY_LABEL_KEY = f"{KWOK_GROUP}/instance-family"
INSTANCE_MEMORY_LABEL_KEY = f"{KWOK_GROUP}/instance-memory"
INSTANCE_CPU_LABEL_KEY = f"{KWOK_GROUP}/instance-cpu"

well_known.WELL_KNOWN_LABELS.update(
    {
        INSTANCE_SIZE_LABEL_KEY,
        INSTANCE_FAMILY_LABEL_KEY,
        INSTANCE_MEMORY_LABEL_KEY,
        INSTANCE_CPU_LABEL_KEY,
    }
)

KWOK_ZONES = ["test-zone-a", "test-zone-b", "test-zone-c", "test-zone-d"]
KWOK_SIZES = [1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256]
# family -> GiB per vCPU (designs/kwok-provider.md:19-23)
KWOK_FAMILIES = {"c": 2, "s": 4, "m": 8}

# The partition label KWOK nodes are spread over (kwok provider adds
# kwok-partition labels for simulated topology).
PARTITION_LABEL_KEY = f"{KWOK_GROUP}/partition"


def price_from_resources(resources: res.ResourceList) -> float:
    """kwok/tools/gen_instance_types.go:54 priceFromResources."""
    price = 0.0
    for name, millis in resources.items():
        if name == res.CPU:
            price += 0.025 * millis / 1000
        elif name == res.MEMORY:
            price += 0.001 * (millis / 1000) / 1e9
    return price


def construct_instance_types(
    zones: Optional[list[str]] = None,
    sizes: Optional[list[int]] = None,
    families: Optional[dict[str, int]] = None,
    oses: tuple[str, ...] = ("linux", "windows"),
    arches: tuple[str, ...] = ("amd64", "arm64"),
) -> InstanceTypes:
    """The KWOK instance universe (kwok/tools/gen_instance_types.go:69-110 +
    kwok/cloudprovider/helpers.go:120-200 newInstanceType)."""
    zones = zones if zones is not None else KWOK_ZONES
    sizes = sizes if sizes is not None else KWOK_SIZES
    families = families if families is not None else KWOK_FAMILIES
    out = InstanceTypes()
    for cpu, (family, mem_factor), os_, arch in itertools.product(
        sizes, families.items(), oses, arches
    ):
        mem = cpu * mem_factor
        pods = min(cpu * 16, 1024)
        name = f"{family}-{cpu}x-{arch}-{os_}"
        resources = {
            res.CPU: q(str(cpu)),
            res.MEMORY: q(f"{mem}Gi"),
            res.PODS: q(str(pods)),
            res.EPHEMERAL_STORAGE: q("20Gi"),
        }
        price = price_from_resources(resources)
        offerings = Offerings(
            Offering(
                requirements=Requirements.from_labels(
                    {
                        well_known.CAPACITY_TYPE_LABEL_KEY: ct,
                        well_known.TOPOLOGY_ZONE_LABEL_KEY: zone,
                    }
                ),
                price=price * 0.7 if ct == "spot" else price,
                available=True,
            )
            for zone in zones
            for ct in ("spot", "on-demand")
        )
        requirements = Requirements(
            [
                Requirement(well_known.INSTANCE_TYPE_LABEL_KEY, Operator.IN, [name]),
                Requirement(well_known.ARCH_LABEL_KEY, Operator.IN, [arch]),
                Requirement(well_known.OS_LABEL_KEY, Operator.IN, [os_]),
                Requirement(well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, zones),
                Requirement(
                    well_known.CAPACITY_TYPE_LABEL_KEY, Operator.IN, ["spot", "on-demand"]
                ),
                Requirement(INSTANCE_SIZE_LABEL_KEY, Operator.IN, [f"{cpu}x"]),
                Requirement(INSTANCE_FAMILY_LABEL_KEY, Operator.IN, [family]),
                Requirement(INSTANCE_CPU_LABEL_KEY, Operator.IN, [str(cpu)]),
                Requirement(INSTANCE_MEMORY_LABEL_KEY, Operator.IN, [str(mem * 1024)]),
            ]
        )
        out.append(
            InstanceType(
                name=name,
                requirements=requirements,
                offerings=offerings,
                capacity=resources,
                overhead=InstanceTypeOverhead(
                    kube_reserved=res.parse_list({res.CPU: "100m", res.MEMORY: "120Mi"})
                ),
            )
        )
    return out


# ---------------------------------------------------------------------------
# The KWOK cloud provider: fabricates Node objects directly (no kubelet, no
# cloud API), with an async registration delay — reference
# kwok/cloudprovider/cloudprovider.go:58-86 (Create), :185-236 (toNode).


class KwokCloudProvider:
    """CloudProvider whose instances are simulated Nodes in the API store.

    Create() records the instance immediately and queues the Node object to
    appear after `registration_delay` seconds (the reference launches a
    goroutine sleeping NodeRegistrationDelay; with a step clock the queue is
    flushed by reconcile(), which the operator loop and tests drive)."""

    def __init__(
        self,
        kube,
        clock,
        instance_types=None,
        registration_delay_seconds: float = 2.0,
    ):
        from karpenter_tpu_torch.cloudprovider.types import CloudProvider  # noqa: F401

        self.kube = kube
        self.clock = clock
        self.types = (
            instance_types if instance_types is not None else construct_instance_types()
        )
        self._by_name = {it.name: it for it in self.types}
        self.registration_delay = registration_delay_seconds
        self.instances: dict[str, object] = {}  # provider id -> NodeClaim view
        self._pending_nodes: list[tuple[float, object]] = []
        # boot-taint clearing state (reconcile): claim names whose startup
        # taints still need their one-shot removal, and node names already
        # cleared (pruned when the instance is deleted)
        self._boot_pending: set[str] = set()
        self._boot_cleared: set[str] = set()
        self.next_create_error: Optional[Exception] = None
        self.created: list[object] = []
        self.deleted: list[str] = []

    # -- SPI --------------------------------------------------------------

    def create(self, node_claim):
        """Pick the cheapest compatible offering and fabricate the node
        (kwok cloudprovider.go:58,198)."""
        import copy as copy_mod

        from karpenter_tpu_torch.api import labels as wk
        from karpenter_tpu_torch.api.objects import Node, ObjectMeta, Taint
        from karpenter_tpu_torch.cloudprovider.types import CreateError
        from karpenter_tpu_torch.scheduling import Requirements as Reqs_

        if self.next_create_error is not None:
            err, self.next_create_error = self.next_create_error, None
            raise err

        from karpenter_tpu_torch.scheduling import ALLOW_UNDEFINED_WELL_KNOWN_LABELS

        reqs = Reqs_.from_node_selector_requirements(node_claim.requirements)
        best = None  # (price, it, offering)
        for it in self.types:
            if not reqs.is_compatible(
                it.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            ):
                continue
            for o in it.offerings:
                if not o.available:
                    continue
                if not reqs.is_compatible(
                    o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                ):
                    continue
                if best is None or o.price < best[0]:
                    best = (o.price, it, o)
        if best is None:
            raise CreateError(
                "no instance type offering satisfies the claim requirements",
                reason="NoCompatibleOffering",
            )
        _, it, offering = best

        claim = copy_mod.deepcopy(node_claim)
        provider_id = f"kwok://{claim.name}"
        claim.status.provider_id = provider_id
        claim.status.node_name = claim.name
        claim.status.capacity = dict(it.capacity)
        claim.status.allocatable = dict(it.allocatable())
        claim.status.image_id = "kwok-image"
        self.instances[provider_id] = claim
        self.created.append(claim)

        labels = dict(claim.metadata.labels)
        for r in claim.requirements:
            if r.operator == Operator.IN and len(r.values) == 1:
                labels.setdefault(r.key, r.values[0])
        for r in it.requirements.values():
            vals = r.values
            if not r.complement and len(vals) == 1:
                labels[r.key] = next(iter(vals))
        labels[wk.INSTANCE_TYPE_LABEL_KEY] = it.name
        labels[wk.TOPOLOGY_ZONE_LABEL_KEY] = offering.zone()
        labels[wk.CAPACITY_TYPE_LABEL_KEY] = offering.capacity_type()
        labels[wk.HOSTNAME_LABEL_KEY] = claim.name
        labels[PARTITION_LABEL_KEY] = offering.zone()
        # the returned claim carries the resolved labels like the reference
        # kwok provider's toNodeClaim(node) (kwok cloudprovider.go:84) —
        # lifecycle's PopulateNodeClaimDetails merges them onto the stored
        # claim, which RequirementsDrifted later diffs against the nodepool
        claim.metadata.labels = dict(labels)

        node = Node(
            metadata=ObjectMeta(
                name=claim.name,
                labels=labels,
                finalizers=[wk.TERMINATION_FINALIZER],
                owner_uid=claim.metadata.uid,
            ),
            provider_id=provider_id,
            capacity=dict(it.capacity),
            allocatable=dict(it.allocatable()),
            taints=list(claim.taints)
            + list(claim.startup_taints)
            + [Taint(key="karpenter.sh/unregistered", effect="NoExecute")],
            ready=True,
        )
        self._pending_nodes.append(
            (self.clock.now() + self.registration_delay, node)
        )
        if claim.startup_taints:
            self._boot_pending.add(claim.name)
        return claim

    def reconcile(self) -> int:
        """Flush nodes whose registration delay elapsed into the store,
        and clear each node's STARTUP taints exactly once after it joins —
        the fabricated analog of the boot daemonset that tolerates and
        then removes them (nodepool.go:190 startupTaints "expected to be
        removed automatically within a short period of time"). One-shot:
        a startup-keyed taint applied LATER sticks, so initialized-node
        scenarios keep reference semantics (suite_test.go:2145).
        Returns how many nodes joined."""
        from karpenter_tpu_torch.controllers.kube import AlreadyExists, Conflict, NotFound

        now = self.clock.now()
        due = [n for t, n in self._pending_nodes if t <= now]
        self._pending_nodes = [(t, n) for t, n in self._pending_nodes if t > now]
        joined = 0
        for node in due:
            if node.provider_id not in self.instances:
                continue  # deleted before it registered
            try:
                self.kube.create("Node", node)
                joined += 1
            except AlreadyExists:
                pass
        # boot-taint clearing pass — only while some boot is pending, so
        # the common zero-startup-taint path pays nothing per tick
        if self._boot_pending:
            for claim in self.kube.list("NodeClaim"):
                if not claim.startup_taints or not claim.status.node_name:
                    continue
                name = claim.status.node_name
                if name in self._boot_cleared:
                    continue
                node = self.kube.try_get("Node", name)
                if node is None:
                    continue
                self._boot_cleared.add(name)
                self._boot_pending.discard(claim.name)
                boot = {(t.key, t.effect) for t in claim.startup_taints}
                kept = [t for t in node.taints if (t.key, t.effect) not in boot]
                if len(kept) != len(node.taints):
                    node.taints = kept
                    try:
                        self.kube.update("Node", node)
                    except (Conflict, NotFound):
                        # retry next tick
                        self._boot_cleared.discard(name)
                        self._boot_pending.add(claim.name)
        return joined

    def delete(self, node_claim) -> None:
        from karpenter_tpu_torch.cloudprovider.types import NodeClaimNotFoundError
        from karpenter_tpu_torch.controllers.kube import NotFound

        pid = node_claim.status.provider_id or f"kwok://{node_claim.name}"
        if pid not in self.instances:
            raise NodeClaimNotFoundError(pid)
        del self.instances[pid]
        self.deleted.append(pid)
        self._boot_pending.discard(node_claim.name)
        self._boot_cleared.discard(node_claim.status.node_name or node_claim.name)

    def get(self, provider_id: str):
        from karpenter_tpu_torch.cloudprovider.types import NodeClaimNotFoundError

        claim = self.instances.get(provider_id)
        if claim is None:
            raise NodeClaimNotFoundError(provider_id)
        return claim

    def list(self):
        return list(self.instances.values())

    def get_instance_types(self, node_pool):
        return self.types

    def get_instance_types_by_name(self, node_claim):
        from karpenter_tpu_torch.cloudprovider.types import InstanceTypes as ITs

        return ITs(
            it
            for r in node_claim.requirements
            if r.key == well_known.INSTANCE_TYPE_LABEL_KEY
            for name in r.values
            for it in [self._by_name.get(name)]
            if it is not None
        )

    def is_drifted(self, node_claim) -> str:
        return ""  # hash-based drift is detected by the drift controller

    def repair_policies(self):
        from karpenter_tpu_torch.cloudprovider.types import RepairPolicy

        return [
            RepairPolicy(
                condition_type="Ready",
                condition_status="False",
                toleration_seconds=120.0,
            )
        ]

    def name(self) -> str:
        return "kwok"
