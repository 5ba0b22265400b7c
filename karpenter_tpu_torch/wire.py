"""The solver request decoder: a problem's wire form -> the port's objects.

A copy of the reference's request decoder (`_decode_problem_dict` and the
helpers it calls, from its solver/service.py), so a wire payload — a
sidecar request or a fuzz case's `problem` dict — decodes into this
package's own Pods, NodePools, instance types, StateNodeViews and options,
with the same uids, names and option values the reference sees.
"""

from __future__ import annotations

import base64
from typing import Optional

import numpy as np

from karpenter_tpu_torch.api import codec
from karpenter_tpu_torch.solver.nodes import StateNodeView
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.topology import ClusterSource


def _unb64(s: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=dtype)


def _decode_pods_flat(d: dict):
    reps = codec.from_jsonable(d["classes"])
    cls = _unb64(d["cls"], np.int32)
    creation = _unb64(d["creation"], np.float64)
    out = []
    for i in range(len(cls)):
        p = reps[int(cls[i])].deep_copy()
        p.metadata.name = d["names"][i]
        p.metadata.uid = d["uids"][i]
        p.metadata.creation_timestamp = float(creation[i])
        out.append(p)
    return out


def _decode_views(data) -> Optional[list[StateNodeView]]:
    if data is None:
        return None
    out = []
    for d in data:
        v = StateNodeView(
            name=d["name"],
            node_labels=d["node_labels"],
            labels=d["labels"],
            taints=codec.from_jsonable(d["taints"]),
            available={k: int(x) for k, x in d["available"].items()},
            capacity={k: int(x) for k, x in d["capacity"].items()},
            daemonset_requests={
                k: int(x) for k, x in d["daemonset_requests"].items()
            },
            initialized=d["initialized"],
            hostname=d["hostname"],
            csi_allocatable={
                k: int(v2) for k, v2 in d.get("csi_allocatable", {}).items()
            },
        )
        for uid, ports in d.get("host_ports", {}).items():
            v.host_port_usage._by_pod[uid] = [tuple(p) for p in ports]
        for uid, vols in d.get("volumes", {}).items():
            v.volume_usage._by_pod[uid] = {
                tuple(p) if isinstance(p, list) else ("", p) for p in vols
            }
        out.append(v)
    return out


def _decode_cluster(req: dict) -> ClusterSource:
    from karpenter_tpu_torch.api import objects as api

    cl = req.get("cluster")
    if not cl:
        return ClusterSource(namespace_labels=req.get("namespace_labels") or {})
    nodes_by_name = {
        name: api.Node(metadata=api.ObjectMeta(name=name, labels=dict(labels)))
        for name, labels in cl.get("node_labels_by_name", {}).items()
    }
    pods_by_ns = {
        ns: codec.from_jsonable(v)
        for ns, v in cl.get("pods_by_namespace", {}).items()
    }
    return ClusterSource(
        pods_by_ns, nodes_by_name, cl.get("namespace_labels") or {}
    )


def _decode_problem_dict(req: dict):
    """THE request decoder: wire snapshots and delta-materialized epoch
    requests (epochs.materialize_request) both decode here, so a delta
    solve can never diverge from its full-resync twin by construction."""
    node_pools = codec.from_jsonable(req["node_pools"])
    its_by_pool = {
        k: codec.from_jsonable(v) for k, v in req["instance_types_by_pool"].items()
    }
    pods = _decode_pods_flat(req["pods_flat"])
    views = _decode_views(req.get("state_node_views"))
    source = _decode_cluster(req)
    daemons = codec.from_jsonable(req.get("daemonset_pods") or [])
    o = req.get("options") or {}
    defaults = SchedulerOptions()
    options = SchedulerOptions(
        ignore_preferences=o.get("ignore_preferences", False),
        min_values_best_effort=o.get("min_values_best_effort", False),
        reserved_capacity_enabled=o.get("reserved_capacity_enabled", False),
        reserved_offering_strict=o.get("reserved_offering_strict", False),
        timeout_seconds=o.get("timeout_seconds"),
        claim_slot_div=(
            o["claim_slot_div"]
            if o.get("claim_slot_div") is not None
            else defaults.claim_slot_div
        ),
        tpu_min_pods=(
            o["tpu_min_pods"]
            if o.get("tpu_min_pods") is not None
            else defaults.tpu_min_pods
        ),
    )
    return (
        node_pools,
        its_by_pool,
        pods,
        views,
        daemons,
        options,
        req.get("force_oracle", False),
        source,
    )
