"""The shared FFD pod ordering, with a class-grouped tie-break.

The reference sorts pods by CPU-then-memory descending, breaking ties by
creation timestamp then UID (queue.go:72-108). The tie-break is pure
determinism — any total order over equal-request pods yields a valid
first-fit-decreasing run. This framework inserts one extra key between the
requests and the timestamp: a *scheduling-class signature*, a hash of every
pod field that influences the scheduler's per-pod decision (requirements,
constraints, tolerations — NOT the pod's own labels, which only affect what
the pod records into topology counts, never where it can go).

Why: pods of the same class become contiguous in the solve order, which
lets the TPU kernel evaluate a class once and bulk-commit whole runs of
identical pods per device step (solver/tpu_kernel.py run scan) instead of
one pod per step. The oracle uses the same comparator, so oracle/TPU parity
is preserved exactly.
"""

from __future__ import annotations

import zlib

from karpenter_tpu_torch.api.objects import Pod, PodAffinityTerm
from karpenter_tpu_torch.utils import resources as res


# Enum-or-string normalizer: the API enums subclass str, so str.__str__
# returns the underlying value for both an enum member and the plain string
# the wire codec decodes it to — a pod must land in the same class either
# way (the sidecar reconstructs pods from JSON; tests/test_service.py pins
# remote == in-process packing). One C call, unlike f-strings or .value.
_es = str.__str__


def _opt(x):
    return None if x is None else _es(x)


def _selector_key(sel) -> tuple:
    if sel is None:
        return ()
    ml = sel.match_labels
    me = sel.match_expressions
    return (
        tuple(sorted(ml.items())) if ml else (),
        tuple((e.key, _es(e.operator), tuple(sorted(e.values))) for e in me)
        if me
        else (),
    )


def _term_key(t: PodAffinityTerm, pod: Pod) -> tuple:
    sel = t.label_selector
    return (
        t.topology_key,
        _selector_key(sel),
        tuple(sorted(t.namespaces)) if t.namespaces else (),
        _selector_key(t.namespace_selector),
        # whether the term selects the pod itself changes the decision
        # (self-counting in skew math), so it is part of the class
        bool(sel is not None and sel.matches(pod.metadata.labels)),
    )


def pod_class_key(pod: Pod) -> tuple:
    """The canonical tuple of every decision-relevant pod field. Two pods
    with equal keys and equal requests make identical scheduling decisions
    against any solver state (their labels may still differ — labels only
    drive topology-count records, which the kernel applies per pod).
    Memoized on the pod object: the sort and the encoder both consult it
    for every pod of every solve. Dedup uses repr bytes of THIS tuple
    (pod_class_repr — every element has a faithful repr); the crc in
    pod_class_signature is only a sort tie-break, where a collision merely
    reorders ties.

    Enum-valued fields are normalized to their plain string values via _es
    (str.__str__ — one C call; the former str() enum formatting was a
    measured hot spot at 50k pods) so a wire-decoded pod lands in the same
    class as its in-process twin. Empty constraint lists short-circuit to
    () for the same reason: most pods of a big batch carry no affinity/TSC
    at all."""
    cached = getattr(pod, "_ktpu_class_key", None)
    if cached is not None:
        return cached
    na = pod.node_affinity
    labels = pod.metadata.labels
    key = (
        pod.namespace,
        tuple(sorted(pod.node_selector.items())) if pod.node_selector else (),
        tuple(
            (
                tuple(
                    (e.key, _es(e.operator), tuple(sorted(e.values)))
                    for e in term.match_expressions
                ),
            )
            for term in na.required_terms
        )
        if na is not None and na.required_terms
        else (),
        tuple(
            (
                w.weight,
                tuple(
                    (e.key, _es(e.operator), tuple(sorted(e.values)))
                    for e in w.preference.match_expressions
                ),
            )
            for w in na.preferred
        )
        if na is not None and na.preferred
        else (),
        tuple(_term_key(t, pod) for t in pod.pod_affinity)
        if pod.pod_affinity
        else (),
        tuple(_term_key(t, pod) for t in pod.pod_anti_affinity)
        if pod.pod_anti_affinity
        else (),
        tuple(
            (w.weight,) + _term_key(w.term, pod) for w in pod.pod_affinity_preferred
        )
        if pod.pod_affinity_preferred
        else (),
        tuple(
            (w.weight,) + _term_key(w.term, pod)
            for w in pod.pod_anti_affinity_preferred
        )
        if pod.pod_anti_affinity_preferred
        else (),
        tuple(
            (t.key, _opt(t.operator), t.value, _opt(t.effect))
            for t in pod.tolerations
        )
        if pod.tolerations
        else (),
        tuple(
            (
                t.topology_key,
                t.max_skew,
                _es(t.when_unsatisfiable),
                _selector_key(t.label_selector),
                t.min_domains,
                _opt(t.node_taints_policy),
                _opt(t.node_affinity_policy),
                bool(
                    t.label_selector is not None
                    and t.label_selector.matches(labels)
                ),
                tuple((k, labels.get(k)) for k in t.match_label_keys)
                if t.match_label_keys
                else (),
            )
            for t in pod.topology_spread_constraints
        )
        if pod.topology_spread_constraints
        else (),
        tuple(sorted(pod.host_ports)) if pod.host_ports else (),
        tuple(sorted(pod.volume_claims)) if pod.volume_claims else (),
    )
    try:
        pod._ktpu_class_key = key
    except AttributeError:
        pass  # frozen/slotted pods just recompute
    return key


def pod_class_repr(pod: Pod) -> bytes:
    """Canonical byte serialization of pod_class_key — the dedup dict key.
    Python tuples re-hash their full contents on every dict lookup; bytes
    hash in C once, which is what makes 50k-pod class dedup a non-event.
    repr is faithful for everything the key contains (str, int, bool,
    (str, Enum) members, nested tuples), so equal reprs == equal keys."""
    cached = getattr(pod, "_ktpu_class_repr", None)
    if cached is not None:
        return cached
    out = repr(pod_class_key(pod)).encode()
    try:
        pod._ktpu_class_repr = out
    except AttributeError:
        pass
    return out


def pod_class_signature(pod: Pod) -> int:
    """A 32-bit digest of pod_class_key for the FFD sort tie-break only —
    stable across processes (unlike hash()); collisions just group ties
    differently, never merge distinct classes."""
    cached = getattr(pod, "_ktpu_class_sig", None)
    if cached is not None:
        return cached
    sig = zlib.crc32(pod_class_repr(pod))
    try:
        pod._ktpu_class_sig = sig
    except AttributeError:
        pass
    return sig


def pod_encode_class(pod: Pod, requests) -> tuple:
    """Key under which pods share identical solver encodings: the class
    repr bytes plus the exact request vector (exact equality — no hashing
    on the dedup path)."""
    return (pod_class_repr(pod), tuple(sorted(requests.items())))


def ffd_sort_key(pod: Pod, requests: res.ResourceList):
    """queue.go:72 FFD order + class-grouped tie-break (module docstring)."""
    return (
        -requests.get(res.CPU, 0),
        -requests.get(res.MEMORY, 0),
        pod_class_signature(pod),
        pod.metadata.creation_timestamp,
        pod.uid,
    )


def ffd_order_cols(cpu, mem, sig, ts_list: list, uids: list) -> list:
    """Vectorized FFD ordering from pre-built columns: identical total
    order to sorting by ffd_sort_key (np.lexsort and Python sort are both
    stable over the same keys). cpu/mem/sig are int arrays; ts_list/uids
    are plain Python lists (timestamps may be ints wider than float64 —
    see below)."""
    import numpy as np

    n = len(uids)
    if n <= 1:
        return list(range(n))
    ts = np.asarray(ts_list, dtype=np.float64)
    # Integer timestamps above 2^53 (nanosecond epochs) don't round-trip
    # through float64; a lossy column would diverge from ffd_sort_key's
    # exact tuple comparison that the parity contract pins. Verify the
    # round-trip and fall back to the exact Python sort when it fails.
    if ts.tolist() != ts_list:
        order = sorted(
            range(n),
            key=lambda i: (-int(cpu[i]), -int(mem[i]), int(sig[i]), ts_list[i], uids[i]),
        )
        return order
    # least-significant key first. The uid dtype is sized to the longest
    # uid present: a fixed width would silently truncate caller-set uids
    # and break the REQUIRED equivalence with ffd_sort_key's full-string
    # comparison (tests/test_requirements.py pins the equivalence).
    uid = np.array(uids, dtype=object)
    width = max(len(u) for u in uids)
    order = np.lexsort((uid.astype(f"U{width}"), ts, sig, -np.asarray(mem), -np.asarray(cpu)))
    return order.tolist()


def ffd_order(pods: list[Pod], requests_of) -> list:
    """ffd_order_cols over columns gathered from pod objects.
    `requests_of(pod)` returns the cached ResourceList."""
    import numpy as np

    from karpenter_tpu_torch.utils import resources as res

    n = len(pods)
    if n <= 1:
        return list(range(n))
    cpu = np.empty(n, np.int64)
    mem = np.empty(n, np.int64)
    sig = np.empty(n, np.int64)
    ts_list = [0.0] * n
    uids = [""] * n
    for i, p in enumerate(pods):
        r = requests_of(p)
        cpu[i] = r.get(res.CPU, 0)
        mem[i] = r.get(res.MEMORY, 0)
        sig[i] = pod_class_signature(p)
        ts_list[i] = p.metadata.creation_timestamp
        uids[i] = p.uid
    return ffd_order_cols(cpu, mem, sig, ts_list, uids)
