"""Provisioning: the pieces of the reference's `controllers/provisioning.py`
that the cluster state needs.

Only `VolumeTopology` is copied here (PVC zone injection and the CSI driver
resolution `state.wire_informers` hands the cluster cache). The
Provisioner, its batcher and the solve it drives come with the control-plane
slice of the port.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import (
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Operator,
    Pod,
)
from karpenter_tpu_torch.controllers.kube import NotFound, SimKube


class VolumeTopology:
    """PVC zone injection (volumetopology.go:43): before scheduling, rewrite
    each pod's node affinity with the zones its bound/zonal volumes demand."""

    def __init__(self, kube: SimKube):
        self.kube = kube

    def inject(self, pod: Pod) -> None:
        requirements: list[NodeSelectorRequirement] = []
        for claim_name in pod.volume_claims:
            pvc = self.kube.try_get("PersistentVolumeClaim", claim_name)
            if pvc is None:
                continue
            req = self._requirement_for(pvc)
            if req is not None:
                requirements.append(req)
            # resolve the claim's CSI driver for per-driver volume-limit
            # accounting (volumeusage.go:187: pod -> PVC -> StorageClass
            # provisioner), from the same PVC fetch as the zone resolution
            driver = self.driver_for(pvc)
            if driver:
                pod.volume_drivers[claim_name] = driver
        if not requirements:
            return
        if pod.node_affinity is None:
            pod.node_affinity = NodeAffinity()
        if not pod.node_affinity.required_terms:
            pod.node_affinity.required_terms = [NodeSelectorTerm([])]
        # the reference appends to EVERY required term (OR-semantics keep
        # each alternative zone-correct, volumetopology.go:78)
        for term in pod.node_affinity.required_terms:
            term.match_expressions = list(term.match_expressions) + requirements

    def driver_for(self, pvc) -> str:
        """The claim's CSI driver via StorageClass.provisioner ("" when
        unresolvable). Also used by the cluster cache when it tallies
        BOUND pods' volumes (state.py) — attribution must agree between
        the solve-time inject and the bound-pod accounting or per-driver
        budgets double-count into the default bucket."""
        if not pvc.storage_class_name:
            return ""
        sc = self.kube.try_get("StorageClass", pvc.storage_class_name)
        return sc.provisioner if sc is not None else ""

    def resolve_drivers(self, pod: Pod) -> None:
        """Fill pod.volume_drivers in place (claim -> CSI driver)."""
        for claim_name in pod.volume_claims:
            if claim_name in pod.volume_drivers:
                continue
            pvc = self.kube.try_get("PersistentVolumeClaim", claim_name)
            if pvc is not None:
                driver = self.driver_for(pvc)
                if driver:
                    pod.volume_drivers[claim_name] = driver

    def _requirement_for(self, pvc) -> Optional[NodeSelectorRequirement]:
        zones: list[str] = []
        if pvc.volume_zones:
            zones = list(pvc.volume_zones)  # bound volume wins
        elif pvc.storage_class_name:
            sc = self.kube.try_get("StorageClass", pvc.storage_class_name)
            if sc is not None and sc.zones:
                zones = list(sc.zones)
        if not zones:
            return None
        return NodeSelectorRequirement(
            well_known.TOPOLOGY_ZONE_LABEL_KEY, Operator.IN, zones
        )

    def validate(self, pod: Pod) -> Optional[str]:
        """volumetopology.go:162 ValidatePersistentVolumeClaims: pods whose
        PVCs don't resolve are not schedulable."""
        for claim_name in pod.volume_claims:
            try:
                pvc = self.kube.get("PersistentVolumeClaim", claim_name)
            except NotFound:
                return f"missing persistent volume claim {claim_name!r}"
            if not pvc.volume_name and pvc.storage_class_name:
                sc = self.kube.try_get("StorageClass", pvc.storage_class_name)
                if sc is None:
                    return (
                        f"missing storage class {pvc.storage_class_name!r} "
                        f"for claim {claim_name!r}"
                    )
        return None
