"""The solver wire form: problems and results to and from JSON.

A copy of the reference's problem and result codec (from its
solver/service.py). The encode side (`encode_problem_dict`,
`encode_problem_request`, `_encode_result`) writes the same bytes as the
reference for the same problem: the same key order, float formatting and
base64 padding, so the port's sidecar and the reference's clients speak
one protocol. The decode side (`_decode_problem_dict`, `decode_result`)
turns a wire payload — a sidecar request or a fuzz case's `problem`
dict — into this package's own Pods, NodePools, instance types,
StateNodeViews and options, with the same uids, names and option values
the reference sees.

Pods ride as one JSON spec per scheduling class plus flat base64 columns
(class index, creation timestamp) and name/uid lists: O(classes) JSON and
O(pods) binary. A result is a JSON header plus a flat base64 assignment
array: pod i -> claim index, or -2 - existing-node index, or -1.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

from karpenter_tpu_torch.api import codec
from karpenter_tpu_torch.solver.nodes import StateNodeView
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.topology import ClusterSource


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _unb64(s: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=dtype)


def _encode_pods_flat(pods) -> dict:
    """Class-deduplicated pod payload: one JSON spec per scheduling class
    plus flat per-pod identity columns."""
    from karpenter_tpu_torch.solver.ordering import pod_encode_class

    classes: dict[tuple, int] = {}
    reps = []
    cls = np.zeros(len(pods), np.int32)
    for i, p in enumerate(pods):
        key = pod_encode_class(p, p.requests) + (
            tuple(sorted(p.metadata.labels.items())),
            tuple(sorted(p.metadata.annotations.items())),
            p.namespace,
        )
        c = classes.get(key)
        if c is None:
            c = len(reps)
            classes[key] = c
            reps.append(p)
        cls[i] = c
    return {
        "classes": codec.to_jsonable(reps),
        "cls": _b64(cls),
        "names": [p.name for p in pods],
        "uids": [p.uid for p in pods],
        "creation": _b64(
            np.asarray([p.metadata.creation_timestamp for p in pods], np.float64)
        ),
    }


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


def _encode_views(views) -> list[dict]:
    out = []
    for v in views or []:
        out.append(
            {
                "name": v.name,
                # copied, not aliased: the epoch client RETAINS these
                # dicts as its acked sections — an alias would make an
                # in-place caller mutation compare equal to itself in
                # diff_sections and silently desync client and server
                "node_labels": dict(v.node_labels),
                "labels": dict(v.labels),
                "taints": codec.to_jsonable(list(v.taints)),
                "available": dict(v.available),
                "capacity": dict(v.capacity),
                "daemonset_requests": dict(v.daemonset_requests),
                "initialized": v.initialized,
                "hostname": v.hostname,
                "host_ports": {
                    uid: [list(p) for p in ports]
                    for uid, ports in v.host_port_usage._by_pod.items()
                },
                "volumes": {
                    uid: sorted([list(p) for p in s])
                    for uid, s in v.volume_usage._by_pod.items()
                },
                "csi_allocatable": dict(getattr(v, "csi_allocatable", {}) or {}),
            }
        )
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


def _encode_cluster(cluster) -> Optional[dict]:
    """The ClusterSource slice topology counting needs on the server side:
    scheduled pods by namespace (existing anti-affinity / spread-count
    state), node labels by name, and namespace labels."""
    if cluster is None:
        return None
    return {
        "namespace_labels": dict(cluster.namespace_labels),
        "pods_by_namespace": {
            ns: codec.to_jsonable([p for p in pods if p.node_name])
            for ns, pods in cluster.pods_by_namespace.items()
        },
        "node_labels_by_name": {
            name: dict(node.metadata.labels)
            for name, node in cluster.nodes_by_name.items()
        },
    }


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


def encode_problem_dict(
    node_pools,
    instance_types_by_pool,
    pods,
    state_node_views=None,
    daemonset_pods=None,
    options: Optional[SchedulerOptions] = None,
    force_oracle: bool = False,
    namespace_labels: Optional[dict] = None,
    cluster=None,
) -> dict:
    """The full-snapshot request dict — json.dumps of this IS the SOLVE
    payload (encode_problem_request), and epochs.sections_from_request
    decomposes it into the epoch sections, so the snapshot, the
    epoch-establishing snapshot, and the delta-materialized request all
    share ONE canonical schema."""
    if namespace_labels is None and cluster is not None:
        namespace_labels = cluster.namespace_labels
    return {
        # copied for the same retained-sections reason as _encode_views
        "namespace_labels": dict(namespace_labels or {}),
        "cluster": _encode_cluster(cluster),
        "node_pools": codec.to_jsonable(node_pools),
        "instance_types_by_pool": {
            k: codec.to_jsonable(list(v)) for k, v in instance_types_by_pool.items()
        },
        "pods_flat": _encode_pods_flat(pods),
        "state_node_views": (
            _encode_views(state_node_views) if state_node_views is not None else None
        ),
        "daemonset_pods": codec.to_jsonable(daemonset_pods or []),
        # EVERY SchedulerOptions field crosses the wire: a sidecar solving
        # with defaults while the control plane configured otherwise is a
        # silent decision divergence
        "options": {
            "ignore_preferences": bool(options and options.ignore_preferences),
            "min_values_best_effort": bool(options and options.min_values_best_effort),
            "reserved_capacity_enabled": bool(
                options and options.reserved_capacity_enabled
            ),
            "reserved_offering_strict": bool(
                options and options.reserved_offering_strict
            ),
            "timeout_seconds": options.timeout_seconds if options else None,
            "claim_slot_div": options.claim_slot_div if options else None,
            "tpu_min_pods": options.tpu_min_pods if options else None,
        },
        "force_oracle": force_oracle,
    }


def encode_problem_request(
    node_pools,
    instance_types_by_pool,
    pods,
    state_node_views=None,
    daemonset_pods=None,
    options: Optional[SchedulerOptions] = None,
    force_oracle: bool = False,
    namespace_labels: Optional[dict] = None,
    cluster=None,
) -> bytes:
    return json.dumps(
        encode_problem_dict(
            node_pools,
            instance_types_by_pool,
            pods,
            state_node_views,
            daemonset_pods,
            options,
            force_oracle,
            namespace_labels,
            cluster,
        )
    ).encode()


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


def _encode_result(results, used_tpu: bool, pods) -> bytes:
    """Flat assignment arrays: pod i (request order) -> claim index, or
    ~existing-node index; -1 = error/unscheduled."""
    claim_of = {}
    for ci, c in enumerate(results.new_node_claims):
        for p in c.pods:
            claim_of[p.uid] = ci
    enode_names = [n.name for n in results.existing_nodes]
    enode_of = {}
    for ei, n in enumerate(results.existing_nodes):
        for p in n.pods:
            enode_of[p.uid] = ei
    assign = np.full(len(pods), -1, np.int32)
    for i, p in enumerate(pods):
        if p.uid in claim_of:
            assign[i] = claim_of[p.uid]
        elif p.uid in enode_of:
            assign[i] = -2 - enode_of[p.uid]  # -2 -> node 0, -3 -> node 1, ...
    # the claims share one launch-price memo, as create_node_claims does:
    # the bytes are the unshared ones, without a price lookup per claim
    prices: dict = {}
    claims = [
        {
            "nodepool": c.nodepool_name,
            "instance_types": [it.name for it in c.instance_type_options],
            "requests": dict(c.requests),
            # the launchable form: requirements, taints, labels — everything
            # the control plane's CreateNodeClaims needs, so a REMOTE solve
            # is actionable without re-deriving template state client-side
            "node_claim": codec.to_jsonable(c.to_node_claim(prices)),
        }
        for c in results.new_node_claims
    ]
    out = {
        "used_tpu": used_tpu,
        "timed_out": results.timed_out,
        "pod_errors": dict(results.pod_errors),
        "new_node_claims": claims,
        "existing_node_names": enode_names,
        "assign": _b64(assign),
    }
    return json.dumps(out).encode()


def decode_result(resp: dict, pods) -> dict:
    """Expand the flat assignment array back into per-pod maps."""
    assign = _unb64(resp["assign"], np.int32)
    claims = [dict(c, pod_uids=[]) for c in resp["new_node_claims"]]
    for c in claims:
        if c.get("node_claim") is not None:
            c["node_claim"] = codec.from_jsonable(c["node_claim"])
    existing = {}
    for i, p in enumerate(pods):
        a = int(assign[i])
        if a >= 0:
            claims[a]["pod_uids"].append(p.uid)
        elif a <= -2:
            existing[p.uid] = resp["existing_node_names"][-2 - a]
    return {
        "used_tpu": resp["used_tpu"],
        "timed_out": resp["timed_out"],
        "pod_errors": resp["pod_errors"],
        "new_node_claims": claims,
        "existing_assignments": existing,
    }
