"""In-memory fake cloud provider + instance-type factories for tests and
benchmarks (upstream pkg/cloudprovider/fake/{cloudprovider,instancetype}.go):
the port's copy of karpenter_tpu/cloudprovider/fake.py, on the port's own
api, cloudprovider and scheduling modules.

The `instance_types(n)` factory replicates the reference's fake.InstanceTypes
exactly — n types with incrementing resources (i+1 vCPU, 2(i+1) Gi, 10(i+1)
pods), five offerings each across 3 zones x {spot, on-demand} — because the
reference's scheduling benchmark (scheduling_benchmark_test.go:229) is defined
against that universe and our BASELINE comparisons must share it.
"""

from __future__ import annotations

import copy
import itertools
import threading
from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    NodeClaim,
    NodeClaimStatus,
    NodePool,
    Operator,
)
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InstanceTypeOverhead,
    InstanceTypes,
    NodeClaimNotFoundError,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling import Requirement, Requirements
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.quantity import parse as q

# Fake well-known labels (reference fake/instancetype.go:33-47)
LABEL_INSTANCE_SIZE = "size"
EXOTIC_INSTANCE_LABEL_KEY = "special"
INTEGER_INSTANCE_LABEL_KEY = "integer"
RESOURCE_GPU_VENDOR_A = "fake.com/vendor-a"
RESOURCE_GPU_VENDOR_B = "fake.com/vendor-b"

well_known.WELL_KNOWN_LABELS.update(
    {LABEL_INSTANCE_SIZE, EXOTIC_INSTANCE_LABEL_KEY, INTEGER_INSTANCE_LABEL_KEY}
)


def price_from_resources(resources: res.ResourceList) -> float:
    """fake/instancetype.go:223 PriceFromResources."""
    price = 0.0
    for name, millis in resources.items():
        if name == res.CPU:
            price += 0.1 * millis / 1000
        elif name == res.MEMORY:
            price += 0.1 * (millis / 1000) / 1e9
        elif name in (RESOURCE_GPU_VENDOR_A, RESOURCE_GPU_VENDOR_B):
            price += 1.0
    return price


def new_instance_type(
    name: str,
    resources: Optional[res.ResourceList] = None,
    offerings: Optional[Offerings] = None,
    architecture: str = "amd64",
    operating_systems: Optional[set[str]] = None,
    custom_requirements: Optional[list[Requirement]] = None,
) -> InstanceType:
    """Replicates fake.NewInstanceType (fake/instancetype.go:49-153)."""
    resources = dict(resources or {})
    resources.setdefault(res.CPU, q("4"))
    resources.setdefault(res.MEMORY, q("4Gi"))
    resources.setdefault(res.PODS, q("5"))
    operating_systems = operating_systems or {"linux", "windows", "darwin"}
    if offerings is None:
        price = price_from_resources(resources)
        offerings = Offerings(
            Offering(
                requirements=Requirements.from_labels(
                    {
                        well_known.CAPACITY_TYPE_LABEL_KEY: ct,
                        well_known.TOPOLOGY_ZONE_LABEL_KEY: zone,
                    }
                ),
                price=price,
                available=True,
            )
            for ct, zone in [
                ("spot", "test-zone-1"),
                ("spot", "test-zone-2"),
                ("on-demand", "test-zone-1"),
                ("on-demand", "test-zone-2"),
                ("on-demand", "test-zone-3"),
            ]
        )
    available = Offerings(o for o in offerings if o.available)
    zones = sorted({o.zone() for o in available})
    capacity_types = sorted({o.capacity_type() for o in available})
    requirements = Requirements(
        [
            Requirement(well_known.INSTANCE_TYPE_LABEL_KEY, Operator.IN, [name]),
            Requirement(well_known.ARCH_LABEL_KEY, Operator.IN, [architecture]),
            Requirement(well_known.OS_LABEL_KEY, Operator.IN, sorted(operating_systems)),
            Requirement(well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, zones),
            Requirement(well_known.CAPACITY_TYPE_LABEL_KEY, Operator.IN, capacity_types),
            Requirement(INTEGER_INSTANCE_LABEL_KEY, Operator.IN, [str(resources[res.CPU] // 1000)]),
        ]
    )
    # large instances carry size=large + special=optional; small carry size=small
    # (fake/instancetype.go:126-139)
    if resources[res.CPU] > q("4") and resources[res.MEMORY] > q("8Gi"):
        requirements.add(Requirement(LABEL_INSTANCE_SIZE, Operator.IN, ["large"]))
        requirements.add(Requirement(EXOTIC_INSTANCE_LABEL_KEY, Operator.IN, ["optional"]))
    else:
        requirements.add(Requirement(LABEL_INSTANCE_SIZE, Operator.IN, ["small"]))
        requirements.add(Requirement(EXOTIC_INSTANCE_LABEL_KEY, Operator.DOES_NOT_EXIST))
    for cr in custom_requirements or []:
        requirements.add(cr)
    return InstanceType(
        name=name,
        requirements=requirements,
        offerings=offerings,
        capacity=resources,
        overhead=InstanceTypeOverhead(
            kube_reserved=res.parse_list({res.CPU: "100m", res.MEMORY: "10Mi"})
        ),
    )


def default_instance_types() -> InstanceTypes:
    """The reference fake provider's DEFAULT universe
    (fake/cloudprovider.go:234-271): default, small, two gpu vendors, an
    arm type with exotic operating systems, and a single-pod type. The
    scheduling suite's instance-type-compatibility scenarios are written
    against exactly this set."""
    return InstanceTypes(
        [
            new_instance_type(name="default-instance-type"),
            new_instance_type(
                name="small-instance-type",
                resources={res.CPU: q("2"), res.MEMORY: q("2Gi")},
            ),
            new_instance_type(
                name="gpu-vendor-instance-type",
                resources={RESOURCE_GPU_VENDOR_A: q("2")},
            ),
            new_instance_type(
                name="gpu-vendor-b-instance-type",
                resources={RESOURCE_GPU_VENDOR_B: q("2")},
            ),
            new_instance_type(
                name="arm-instance-type",
                architecture="arm64",
                operating_systems={"ios", "linux", "windows", "darwin"},
                resources={res.CPU: q("16"), res.MEMORY: q("128Gi")},
            ),
            new_instance_type(
                name="single-pod-instance-type",
                resources={res.PODS: q("1")},
            ),
        ]
    )


def instance_types(total: int) -> InstanceTypes:
    """fake.InstanceTypes(total): incrementing 1..total vCPU, 2..2*total Gi,
    10..10*total pods (fake/instancetype.go:200)."""
    return InstanceTypes(
        new_instance_type(
            name=f"fake-it-{i}",
            resources={
                res.CPU: q(str(i + 1)),
                res.MEMORY: q(f"{(i + 1) * 2}Gi"),
                res.PODS: q(str((i + 1) * 10)),
            },
        )
        for i in range(total)
    )


def instance_types_assorted() -> InstanceTypes:
    """fake.InstanceTypesAssorted: cartesian product over cpu x mem x zone x
    capacity-type x os x arch (fake/instancetype.go:156)."""
    out = InstanceTypes()
    for cpu, mem, zone, ct, os_, arch in itertools.product(
        [1, 2, 4, 8, 16, 32, 64],
        [1, 2, 4, 8, 16, 32, 64, 128],
        ["test-zone-1", "test-zone-2", "test-zone-3"],
        ["spot", "on-demand"],
        ["linux", "windows"],
        ["amd64", "arm64"],
    ):
        resources = {res.CPU: q(str(cpu)), res.MEMORY: q(f"{mem}Gi")}
        out.append(
            new_instance_type(
                name=f"{cpu}-cpu-{mem}-mem-{arch}-{os_}-{zone}-{ct}",
                architecture=arch,
                operating_systems={os_},
                resources=resources,
                offerings=Offerings(
                    [
                        Offering(
                            requirements=Requirements.from_labels(
                                {
                                    well_known.CAPACITY_TYPE_LABEL_KEY: ct,
                                    well_known.TOPOLOGY_ZONE_LABEL_KEY: zone,
                                }
                            ),
                            price=price_from_resources(resources),
                            available=True,
                        )
                    ]
                ),
            )
        )
    return out


class FakeCloudProvider(CloudProvider):
    """Records SPI calls, supports injected errors and per-NodePool instance
    types (reference fake/cloudprovider.go:52-546)."""

    def __init__(self, types: Optional[InstanceTypes] = None):
        self.instance_types_list = types if types is not None else instance_types(5)
        self.instance_types_for_nodepool: dict[str, InstanceTypes] = {}
        self.created: dict[str, NodeClaim] = {}  # provider_id -> claim
        self.create_calls: list[NodeClaim] = []
        self.delete_calls: list[NodeClaim] = []
        self.next_create_err: Optional[Exception] = None
        self.next_delete_err: Optional[Exception] = None
        self.next_get_err: Optional[Exception] = None
        self.drifted: str = ""
        self.repair_policy_list = []
        self.allow_insufficient_capacity = False
        self._seq = itertools.count(1)
        self._lock = threading.Lock()

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        with self._lock:
            self.create_calls.append(node_claim)
            if self.next_create_err is not None:
                err, self.next_create_err = self.next_create_err, None
                raise err
            reqs = Requirements.from_node_selector_requirements(node_claim.requirements)
            # pick the cheapest compatible instance type the way the KWOK
            # provider does (kwok/cloudprovider/cloudprovider.go:198-215)
            its = InstanceTypes(
                it
                for it in self.get_instance_types_by_name(node_claim)
                if reqs.intersects(it.requirements) is None
                and it.offerings.available().has_compatible(reqs)
            )
            if not its:
                from karpenter_tpu_torch.cloudprovider.types import InsufficientCapacityError

                raise InsufficientCapacityError(
                    f"no instance type satisfies {node_claim.name}"
                )
            its.order_by_price(reqs)
            it = its[0]
            offering = min(
                (o for o in it.offerings.available().compatible(reqs)),
                key=lambda o: o.price,
            )
            provider_id = f"fake:///{it.name}/{next(self._seq):06d}"
            created = NodeClaim(
                metadata=copy.deepcopy(node_claim.metadata),
                requirements=node_claim.requirements,
                taints=node_claim.taints,
                startup_taints=node_claim.startup_taints,
                node_class_ref=node_claim.node_class_ref,
                status=NodeClaimStatus(
                    provider_id=provider_id,
                    capacity=dict(it.capacity),
                    allocatable=dict(it.allocatable()),
                ),
            )
            created.metadata.labels = dict(node_claim.metadata.labels)
            created.metadata.labels[well_known.INSTANCE_TYPE_LABEL_KEY] = it.name
            created.metadata.labels[well_known.TOPOLOGY_ZONE_LABEL_KEY] = offering.zone()
            created.metadata.labels[well_known.CAPACITY_TYPE_LABEL_KEY] = offering.capacity_type()
            self.created[provider_id] = created
            return created

    def delete(self, node_claim: NodeClaim) -> None:
        with self._lock:
            self.delete_calls.append(node_claim)
            if self.next_delete_err is not None:
                err, self.next_delete_err = self.next_delete_err, None
                raise err
            if node_claim.status.provider_id not in self.created:
                raise NodeClaimNotFoundError(node_claim.status.provider_id)
            del self.created[node_claim.status.provider_id]

    def get(self, provider_id: str) -> NodeClaim:
        with self._lock:
            if self.next_get_err is not None:
                err, self.next_get_err = self.next_get_err, None
                raise err
            if provider_id not in self.created:
                raise NodeClaimNotFoundError(provider_id)
            return self.created[provider_id]

    def list(self) -> list[NodeClaim]:
        with self._lock:
            return list(self.created.values())

    def get_instance_types(self, node_pool: NodePool) -> InstanceTypes:
        return self.instance_types_for_nodepool.get(
            node_pool.name, self.instance_types_list
        )

    def get_instance_types_by_name(self, node_claim: NodeClaim) -> InstanceTypes:
        pool = node_claim.nodepool_name
        if pool and pool in self.instance_types_for_nodepool:
            return self.instance_types_for_nodepool[pool]
        return self.instance_types_list

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted

    def repair_policies(self):
        return self.repair_policy_list

    def name(self) -> str:
        return "fake"

    def reset(self) -> None:
        with self._lock:
            self.created.clear()
            self.create_calls.clear()
            self.delete_calls.clear()
            self.next_create_err = None
            self.next_delete_err = None
            self.drifted = ""
