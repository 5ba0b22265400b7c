"""PodDisruptionBudget limits (reference pkg/utils/pdb/
pdb.go:41-160): which pods can be evicted right now, and which block
disruption entirely."""

from __future__ import annotations

import math
from typing import Any, Optional

from karpenter_tpu_torch.api.objects import Pod, PodDisruptionBudget, PodPhase


def _parse_intstr(raw: str, total: int, round_up: bool) -> int:
    raw = raw.strip()
    if raw.endswith("%"):
        pct = float(raw[:-1]) / 100.0
        v = total * pct
        return math.ceil(v) if round_up else math.floor(v)
    return int(raw)


class PDBLimits:
    """pdb.Limits: per-PDB remaining disruption allowance over the current
    pod population."""

    def __init__(self, pdbs: list[PodDisruptionBudget], all_pods: list[Pod]):
        self.pdbs = pdbs
        self._allowed: dict[str, int] = {}
        self._matching: dict[str, list[Pod]] = {}
        for pdb in pdbs:
            matching = [
                p
                for p in all_pods
                if p.namespace == pdb.metadata.namespace
                and pdb.selector.matches(p.metadata.labels)
            ]
            healthy = sum(
                1
                for p in matching
                if p.phase == PodPhase.RUNNING and not p.terminating
            )
            total = len(matching)
            if pdb.max_unavailable is not None:
                max_unavail = _parse_intstr(pdb.max_unavailable, total, round_up=False)
                unavailable = total - healthy
                allowed = max(0, max_unavail - unavailable)
            elif pdb.min_available is not None:
                min_avail = _parse_intstr(pdb.min_available, total, round_up=True)
                allowed = max(0, healthy - min_avail)
            else:
                allowed = total
            self._allowed[pdb.name] = allowed
            self._matching[pdb.name] = matching

    @classmethod
    def from_kube(cls, kube: Any) -> "PDBLimits":
        pdbs = kube.list("PodDisruptionBudget")
        # with no budget to count against, no pod needs listing
        return cls(pdbs, kube.list("Pod") if pdbs else [])

    def _pdbs_for(self, pod: Pod) -> list[PodDisruptionBudget]:
        return [
            pdb
            for pdb in self.pdbs
            if pod.namespace == pdb.metadata.namespace
            and pdb.selector.matches(pod.metadata.labels)
        ]

    def can_evict(self, pod: Pod) -> tuple[bool, Optional[str]]:
        """Whether evicting this pod is allowed right now; reason otherwise
        (pdb.go CanEvictPods)."""
        for pdb in self._pdbs_for(pod):
            if self._allowed.get(pdb.name, 0) <= 0:
                return False, f"pdb {pdb.name!r} prevents pod evictions"
        return True, None

    def record_eviction(self, pod: Pod) -> None:
        for pdb in self._pdbs_for(pod):
            self._allowed[pdb.name] = max(0, self._allowed.get(pdb.name, 0) - 1)

    def is_fully_blocked(self, pod: Pod) -> Optional[str]:
        """Multiple PDBs selecting the same pod make eviction undefined
        (reference treats >1 PDB as a blocking misconfiguration)."""
        matching = self._pdbs_for(pod)
        if len(matching) > 1:
            names = ", ".join(p.name for p in matching)
            return f"pod covered by multiple pdbs ({names})"
        return None
