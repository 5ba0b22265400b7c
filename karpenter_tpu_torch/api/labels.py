"""Well-known labels, capacity types, and label policy.

Mirrors the reference's label taxonomy in pkg/apis/v1/labels.go:31-180:
which labels the autoscaler understands natively, which are restricted, and how
deprecated label aliases normalize to their stable names.
"""

from __future__ import annotations

GROUP = "karpenter.sh"

# Architectures / capacity types
ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# Autoscaler-specific labels
NODEPOOL_LABEL_KEY = f"{GROUP}/nodepool"
# NodeClass back-reference label (reference labels.go:188 NodeClassLabelKey
# builds "<group>/<kind>"; node-class refs are plain names here, so one
# stable key stands in for the group-kind family)
NODECLASS_LABEL_KEY = f"{GROUP}/nodeclass"
NODE_INITIALIZED_LABEL_KEY = f"{GROUP}/initialized"
NODE_REGISTERED_LABEL_KEY = f"{GROUP}/registered"
CAPACITY_TYPE_LABEL_KEY = f"{GROUP}/capacity-type"

# Autoscaler-specific annotations
DO_NOT_DISRUPT_ANNOTATION_KEY = f"{GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION_KEY = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = f"{GROUP}/nodepool-hash-version"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = f"{GROUP}/nodeclaim-termination-timestamp"
NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY = f"{GROUP}/nodeclaim-min-values-relaxed"
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Kubernetes well-known node labels
HOSTNAME_LABEL_KEY = "kubernetes.io/hostname"
TOPOLOGY_ZONE_LABEL_KEY = "topology.kubernetes.io/zone"
TOPOLOGY_REGION_LABEL_KEY = "topology.kubernetes.io/region"
INSTANCE_TYPE_LABEL_KEY = "node.kubernetes.io/instance-type"
ARCH_LABEL_KEY = "kubernetes.io/arch"
OS_LABEL_KEY = "kubernetes.io/os"
WINDOWS_BUILD_LABEL_KEY = "node.kubernetes.io/windows-build"

# The reservation-id label a provider reports for `reserved` capacity offerings
# (reference: pkg/cloudprovider/types.go ReservationIDLabel is provider-set; we
# standardize one for the in-tree providers).
RESERVATION_ID_LABEL_KEY = f"{GROUP}/reservation-id"

# Domains either prohibited by the kubelet or reserved by the autoscaler
# (reference labels.go:69 RestrictedLabelDomains).
RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})

# Sub-domains of the restricted domains that are allowed (labels.go:77).
LABEL_DOMAIN_EXCEPTIONS = frozenset(
    {"kops.k8s.io", "node-role.kubernetes.io", "node-restriction.kubernetes.io"}
)

# Labels in the restricted domains the autoscaler understands natively
# (labels.go:86 WellKnownLabels). Mutable on purpose: providers register their
# own well-known labels (the fake provider adds size/special/integer keys just
# like the reference's fake provider does in fake/instancetype.go:41-47).
WELL_KNOWN_LABELS: set[str] = {
    NODEPOOL_LABEL_KEY,
    TOPOLOGY_ZONE_LABEL_KEY,
    TOPOLOGY_REGION_LABEL_KEY,
    INSTANCE_TYPE_LABEL_KEY,
    ARCH_LABEL_KEY,
    OS_LABEL_KEY,
    CAPACITY_TYPE_LABEL_KEY,
    WINDOWS_BUILD_LABEL_KEY,
}

# Labels that must never be used on NodePools/NodeClaims because they interfere
# with provisioning (labels.go:124 RestrictedLabels).
RESTRICTED_LABELS = frozenset({HOSTNAME_LABEL_KEY})

# Deprecated label aliases -> stable names (labels.go:130 NormalizedLabels).
NORMALIZED_LABELS: dict[str, str] = {
    "failure-domain.beta.kubernetes.io/zone": TOPOLOGY_ZONE_LABEL_KEY,
    "failure-domain.beta.kubernetes.io/region": TOPOLOGY_REGION_LABEL_KEY,
    "beta.kubernetes.io/arch": ARCH_LABEL_KEY,
    "beta.kubernetes.io/os": OS_LABEL_KEY,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE_LABEL_KEY,
}

# Values the autoscaler expects for specific requirement keys
# (labels.go:105 WellKnownValuesForRequirements).
WELL_KNOWN_VALUES_FOR_REQUIREMENTS: dict[str, frozenset[str]] = {
    CAPACITY_TYPE_LABEL_KEY: frozenset(
        {CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT, CAPACITY_TYPE_RESERVED}
    ),
}


def get_label_domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""


def is_restricted_node_label(key: str) -> bool:
    """True if the autoscaler should not inject this label onto nodes
    (reference labels.go:163 IsRestrictedNodeLabel)."""
    if key in WELL_KNOWN_LABELS:
        return True
    domain = get_label_domain(key)
    for exception in LABEL_DOMAIN_EXCEPTIONS:
        if domain.endswith(exception):
            return False
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain == restricted or domain.endswith("." + restricted):
            return True
    return key in RESTRICTED_LABELS


def is_restricted_label(key: str) -> str | None:
    """Returns an error string if the label may not be used on NodePools
    (reference labels.go:139 IsRestrictedLabel)."""
    if key in WELL_KNOWN_LABELS:
        return None
    if is_restricted_node_label(key):
        return (
            f"label {key!r} is restricted; specify a well known label "
            f"or a custom label that does not use a restricted domain"
        )
    return None
