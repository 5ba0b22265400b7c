"""Taint/toleration matching (reference pkg/scheduling/taints.go)."""

from __future__ import annotations

from typing import Iterable, Optional

from karpenter_tpu_torch.api import labels as well_known
from karpenter_tpu_torch.api.objects import Pod, Taint, TaintEffect, Toleration

# Taints expected on a node while it's initializing; ignored for uninitialized
# managed nodes (reference taints.go:37 KnownEphemeralTaints).
KNOWN_EPHEMERAL_TAINTS: list[Taint] = [
    Taint("node.kubernetes.io/not-ready", TaintEffect.NO_SCHEDULE),
    Taint("node.kubernetes.io/not-ready", TaintEffect.NO_EXECUTE),
    Taint("node.kubernetes.io/unreachable", TaintEffect.NO_SCHEDULE),
    Taint("node.cloudprovider.kubernetes.io/uninitialized", TaintEffect.NO_SCHEDULE, "true"),
]

# The taint a provisioned-but-unregistered node carries (reference apis/v1).
UNREGISTERED_TAINT = Taint(f"{well_known.GROUP}/unregistered", TaintEffect.NO_EXECUTE)

# The taint the disruption machinery applies before draining (reference
# apis/v1 DisruptedNoScheduleTaint).
DISRUPTED_TAINT = Taint(f"{well_known.GROUP}/disrupted", TaintEffect.NO_SCHEDULE)


class Taints(list):
    """Decorated list of Taint (reference taints.go:45)."""

    def tolerates_pod(self, pod: Pod) -> Optional[str]:
        return self.tolerates(pod.tolerations)

    def tolerates(self, tolerations: Iterable[Toleration]) -> Optional[str]:
        """Every taint (of any effect, including PreferNoSchedule — softness is
        handled by the relaxation ladder, preferences.go:140) must be tolerated.
        Returns an error string or None (reference taints.go:53)."""
        tolerations = list(tolerations)
        errs = []
        for taint in self:
            if not any(t.tolerates(taint) for t in tolerations):
                errs.append(
                    f"did not tolerate taint {taint.key}={taint.value}:{taint.effect.value}"
                )
        return "; ".join(errs) if errs else None

    def merge(self, other: Iterable[Taint]) -> "Taints":
        """Union keyed by (key, effect) (reference taints.go:68 Merge)."""
        result = Taints(self)
        for taint in other:
            if not any(t.key == taint.key and t.effect == taint.effect for t in result):
                result.append(taint)
        return result
