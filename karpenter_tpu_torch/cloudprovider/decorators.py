"""CloudProvider decorators: metrics and node-overlay.

Reference:
- metrics decorator pkg/cloudprovider/metrics/cloudprovider.go
  (times and counts every SPI method)
- overlay decorator pkg/cloudprovider/overlay/cloudprovider.go
  (applies NodeOverlay price/capacity patches to GetInstanceTypes results via
  a swap-on-write InstanceTypeStore)
"""

from __future__ import annotations

import copy
from typing import Optional

from karpenter_tpu_torch import metrics

SPI_DURATION = metrics.REGISTRY.histogram(
    "karpenter_cloudprovider_duration_seconds",
    "Duration of cloud provider method calls.",
    ("controller", "method", "provider"),
)
SPI_ERRORS = metrics.REGISTRY.counter(
    "karpenter_cloudprovider_errors_total",
    "Cloud provider method errors.",
    ("controller", "method", "provider"),
)


class MetricsCloudProvider:
    """Wraps any provider; every SPI call is timed and error-counted."""

    _methods = (
        "create",
        "delete",
        "get",
        "list",
        "get_instance_types",
        "is_drifted",
    )

    def __init__(self, inner, controller: str = ""):
        self.inner = inner
        self.controller = controller

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in self._methods or not callable(attr):
            return attr
        provider = self.inner.name()

        def wrapped(*args, **kwargs):
            labels = {
                "controller": self.controller,
                "method": name,
                "provider": provider,
            }
            with SPI_DURATION.measure(labels):
                try:
                    return attr(*args, **kwargs)
                except Exception:
                    SPI_ERRORS.inc(labels)
                    raise

        return wrapped

    def name(self) -> str:
        return self.inner.name()

    def repair_policies(self):
        return self.inner.repair_policies()


class InstanceTypeStore:
    """overlay/store.go:47: overlays evaluated in order into a snapshot that
    swaps atomically; readers never see a half-applied overlay set."""

    def __init__(self):
        self._snapshot: dict[str, list] = {}  # nodepool -> patched types

    def update(self, nodepool_name: str, patched_types: list) -> None:
        self._snapshot[nodepool_name] = patched_types

    def get(self, nodepool_name: str) -> Optional[list]:
        return self._snapshot.get(nodepool_name)

    def clear(self) -> None:
        self._snapshot.clear()


class OverlayCloudProvider:
    """overlay/cloudprovider.go:54: GetInstanceTypes consults the overlay
    store; everything else passes through."""

    def __init__(self, inner, store: InstanceTypeStore):
        self.inner = inner
        self.store = store

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def get_instance_types(self, node_pool):
        patched = self.store.get(node_pool.name)
        if patched is not None:
            return patched
        return self.inner.get_instance_types(node_pool)

    def name(self) -> str:
        return self.inner.name()
