"""Per-node volume attachment tracking and limits.

Reference pkg/scheduling/volumeusage.go:187: the scheduler
tracks which persistent volumes each node would mount and refuses placements
that exceed the node's attachable-volume limit (derived from CSINode
allocatable in the reference; expressed here as a per-node limit surfaced by
the cloud provider / node labels — see VOLUME_LIMIT_LABEL_KEY).
"""

from __future__ import annotations

from typing import Iterable, Optional

from karpenter_tpu_torch.api.objects import Pod

# Node label carrying the attachable-volume limit (the reference reads CSINode
# allocatable; the in-tree providers publish the same number as a label).
VOLUME_LIMIT_LABEL_KEY = "karpenter.sh/volume-attach-limit"


def volume_limit(labels: dict[str, str]) -> Optional[int]:
    raw = labels.get(VOLUME_LIMIT_LABEL_KEY)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


class VolumeUsage:
    """Tracks the distinct volumes mounted per node, attributed per CSI
    DRIVER (reference volumeusage.go:187: CSINode publishes an attachable
    count per driver; a node can run several drivers with separate
    budgets). Volumes are (driver, claim) pairs; claims without a resolved
    driver land in the default "" bucket."""

    def __init__(self) -> None:
        self._by_pod: dict[str, set[tuple[str, str]]] = {}

    def add(self, pod: Pod) -> None:
        if pod.volume_claims:
            drivers = getattr(pod, "volume_drivers", {}) or {}
            self._by_pod[pod.uid] = {
                (drivers.get(c, ""), c) for c in pod.volume_claims
            }

    def remove(self, pod) -> None:
        uid = pod if isinstance(pod, str) else pod.uid
        self._by_pod.pop(uid, None)

    def distinct_volumes(self) -> set[tuple[str, str]]:
        out: set[tuple[str, str]] = set()
        for vols in self._by_pod.values():
            out |= vols
        return out

    def exceeds_limit(
        self,
        pod: Pod,
        limits,
    ) -> Optional[str]:
        """volumeusage.go ExceedsLimits: would mounting the pod's volumes
        push any involved DRIVER past its attachable count? `limits` is a
        dict driver -> count ("" = the label-derived default applied to
        unattributed volumes and drivers without a CSINode entry); a plain
        int is accepted as {"": int} for backward compatibility."""
        if limits is None or not pod.volume_claims:
            return None
        if isinstance(limits, int):
            limits = {"": limits}
        drivers = getattr(pod, "volume_drivers", {}) or {}
        total = self.distinct_volumes() | {
            (drivers.get(c, ""), c) for c in pod.volume_claims
        }
        per_driver: dict[str, int] = {}
        for d, _ in total:
            per_driver[d] = per_driver.get(d, 0) + 1
        for d, n in per_driver.items():
            limit = limits.get(d, limits.get(""))
            if limit is not None and n > limit:
                label = d or "default"
                return (
                    f"would exceed node volume limit for driver "
                    f"{label!r}: {n} > {limit} volumes"
                )
        return None

    def copy(self) -> "VolumeUsage":
        c = VolumeUsage()
        c._by_pod = {k: set(v) for k, v in self._by_pod.items()}
        return c
