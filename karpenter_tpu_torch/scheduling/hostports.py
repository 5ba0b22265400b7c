"""Host-port conflict tracking (reference pkg/scheduling/
hostportusage.go:35)."""

from __future__ import annotations

from typing import Iterable, Optional

from karpenter_tpu_torch.api.objects import Pod

# a host port is (ip, protocol, port)
HostPort = tuple[str, str, int]

_WILDCARD = ("0.0.0.0", "")


def get_host_ports(pod: Pod) -> list[HostPort]:
    return [(ip or "0.0.0.0", proto or "TCP", port) for ip, proto, port in pod.host_ports]


def _conflicts(a: HostPort, b: HostPort) -> bool:
    if a[2] != b[2] or a[1] != b[1]:
        return False
    return a[0] == b[0] or a[0] in _WILDCARD or b[0] in _WILDCARD


class HostPortUsage:
    def __init__(self) -> None:
        self._by_pod: dict[str, list[HostPort]] = {}

    def conflicts(self, pod: Pod, ports: Iterable[HostPort]) -> Optional[str]:
        for port in ports:
            for uid, existing in self._by_pod.items():
                if uid == pod.uid:
                    continue
                for e in existing:
                    if _conflicts(port, e):
                        return f"host port {port} conflicts with existing usage {e}"
        return None

    def add(self, pod: Pod, ports: Iterable[HostPort]) -> None:
        self._by_pod[pod.uid] = list(ports)

    def remove(self, pod) -> None:
        uid = pod if isinstance(pod, str) else pod.uid
        self._by_pod.pop(uid, None)

    def copy(self) -> "HostPortUsage":
        c = HostPortUsage()
        c._by_pod = {k: list(v) for k, v in self._by_pod.items()}
        return c
