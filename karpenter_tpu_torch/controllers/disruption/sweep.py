"""Batched multi-node consolidation: evaluate every candidate-prefix
removal set in one device dispatch.

A port of the reference's `controllers/disruption/sweep.py`. One tensor
problem holds every candidate node as an existing slot plus the union of
all candidates' reschedulable pods (and the pending pods) in FFD order.
Lane k either removes candidates[:k+1] (prefix lanes, multi-node
consolidation) or candidates[k] alone (singleton lanes, single-node
consolidation). A lane is feasible when every valid pod schedules and at
most one new claim opens. The semantic ladder is the reference's:

1. the delta-state fast path (`fast_sweep`, kernel K6): under the fast
   gates (`fast_gate_reason`) FFD of a class-grouped pod sequence is one
   masked cumsum per class over [B, E, R] availability, then the <= 1
   new-claim test on the first workable template;
2. the full-state lane scan (`tpu_kernel.scan_lanes`, kernel K7, the
   reference's `vmap(solve_scan)`), when the gates fail and
   B * |pods| <= 4096;
3. otherwise `SweepUnsupported`: the caller falls to the sequential
   strategies.

The ladder is semantic, not a device fallback: a kernel that fails to
build or launch raises.

K6 `fast_sweep` (csrc/fast_sweep.cu with csrc/sweep_core.cuh).
  Replaces: karpenter_tpu/controllers/disruption/sweep.py:82
  `_ffd_feasibility_core` and :158 `_fast_sweep_kernel` (with
  tpu_runs.py:185 `_build_cache` for the representative pod).
  Bound on an H100: bytes, every lane reads and rewrites its [E, R]
  availability once per class, a few MB at 2000 nodes x 100 lanes. The
  design: one launch builds the run cache and the [T, C] template-fit
  table once (one CTA, the run kernel's `build_cache`), a second launch
  takes one CTA per lane, which walks the classes with a block-wide scan
  of the per-node capacities over E and ends with the lane's template
  verdict. All int32; the host's int64 guards prove no sum wraps.

Every entry point takes `device` (None = the card; "cpu" runs the plain
versions, as the tests do). The port has no tracing yet: `last_sweep`
keeps the path, lanes and odometer steps of the last sweep dispatch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch import _build
from karpenter_tpu_torch.controllers.disruption.types import Candidate
from karpenter_tpu_torch.controllers.state import cluster_source, is_reschedulable
from karpenter_tpu_torch.device import unpack
from karpenter_tpu_torch.ops.encode import Reqs
from karpenter_tpu_torch.solver import tpu_kernel as K
from karpenter_tpu_torch.solver import tpu_problem as tp
from karpenter_tpu_torch.solver import tpu_runs as KR
from karpenter_tpu_torch.solver.oracle import SchedulerOptions
from karpenter_tpu_torch.solver.topology import Topology
from karpenter_tpu_torch.solver.tpu import TorchScheduler, _bulk_gates
from karpenter_tpu_torch.solver.tpu_problem import UnsupportedBySolver, encode_problem

MAX_SWEEP_PREFIXES = 128

# the lane scan's size limit (the reference's: the full-state lanes carry
# B copies of the State, so large non-gated problems go to the sequential
# strategies instead)
MAX_VMAP_LANE_PODS = 4096

# a union problem's claim slots: a consolidation-feasible removal set opens
# at most one new claim, so a set that overflows a handful is infeasible
UNION_CLAIM_SLOTS = 8

# launches of K6 (one per fast_sweep call on the card), counted apart for
# singleton lanes
LAUNCHES = {"fast_sweep": 0, "fast_sweep_singleton": 0}

# the last sweep dispatch: {"path": "sweep_fast" | "sweep_vmap" |
# "setsweep", "lanes": B, "steps": odometer steps}
last_sweep: dict = {}


class SweepUnsupported(Exception):
    """Problem shape outside the batched sweep; use the sequential scan."""


# ---------------------------------------------------------------------------
# the plain versions


def ffd_feasibility_core_plain(tb: K.Tables, rc: KR.RunCache, avail, counts, sizes, with_left=False):
    """The shared body of every delta-state sweep (the reference's
    `_ffd_feasibility_core`): given per-lane availability `avail` [B, E, R]
    (-1 marks a removed slot) and per-lane valid-pod counts `counts` [B, C]
    over the contiguous class sequence (sizes [C, R]), run the class-cumsum
    FFD identity and the <= 1-new-claim check. Returns (feasible [B] bool,
    steps), steps being the class-loop trips (C), and with `with_left` the
    leftover pods per lane and class [B, C] int32 as a third item."""
    dev = avail.device
    B, C = counts.shape
    I = tb.ialloc.shape[0]
    inf = K._i32(K.INF_I, dev)
    zero = K._i32(0, dev)
    ok_e = rc.ok_e  # [E]: one requirement class, the same screen for every class
    avail = avail.clone()
    left = torch.zeros((B, C), dtype=torch.int32, device=dev)
    for c in range(C):
        s = sizes[c]  # [R]
        per = torch.where((s > 0)[None, None, :], avail // torch.clamp(s, min=1)[None, None, :], inf)
        cap = per.min(dim=-1).values
        cap = torch.where(torch.all(avail >= 0, dim=-1), cap.clamp(min=0), zero)
        cap = torch.where(ok_e[None, :], cap, zero)  # [B, E] pod-units per node
        csum = torch.cumsum(cap, dim=1, dtype=torch.int32)
        before = csum - cap
        take = torch.minimum((counts[:, c][:, None] - before).clamp(min=0), cap)
        avail = avail - take[..., None] * s[None, None, :]
        left[:, c] = counts[:, c] - take.sum(dim=1, dtype=torch.int32)
    tot = (left[:, :, None] * sizes[None]).sum(dim=1, dtype=torch.int32)  # [B, R]
    any_left = left.sum(dim=1) > 0

    # <= 1 new claim: the first leftover pod opens a claim on the FIRST
    # template that can host it (scheduler.go:587 template order); every
    # other leftover must fit that same claim
    tmember = unpack(tb.ttypes, I)  # [T, I]
    fit1 = torch.stack(
        [
            KR._type_filter_rows(rc.final_t, tmember, tb.tdaemon + sizes[c][None, :], tb).any(dim=-1)
            for c in range(C)
        ],
        dim=1,
    )  # [T, C]
    cand_t = rc.ok_t[:, None] & fit1
    # the first leftover class per lane; a lane with none takes class 0, as
    # the reference's argmax of all-false does (its verdict is True then)
    c0 = K._first_true(left > 0)  # [B]
    ct = cand_t[:, c0]  # [T, B]
    has_t = ct.any(dim=0)
    tstar = K._first_true(ct.T)  # [B]
    final_b = KR._rows_at(rc.final_t, tstar)
    fit_tot = KR._type_filter_rows(final_b, tmember[tstar], tb.tdaemon[tstar] + tot, tb).any(dim=-1)
    claim_ok = has_t & fit_tot
    feasible = torch.where(any_left, claim_ok, torch.ones_like(claim_ok))
    return (feasible, C, left) if with_left else (feasible, C)


def _lane_avail(avail0, removed):
    """[B, E, R]: the base availability with removed slots at -1."""
    return torch.where(removed[..., None], K._i32(-1, avail0.device), avail0[None])


def fast_sweep_plain(
    tb: K.Tables, st: K.State, x: K.PodX, avail0, cand_idx, counts, sizes, singleton=False, with_left=False
):
    """The reference's `_fast_sweep_kernel` for one pod row `x`: prefix
    lane k removes candidates[:k+1], singleton lane k candidates[k] alone.
    Returns (feasible [B] bool, steps), and the leftovers [B, C] with
    `with_left`."""
    rc = KR._build_cache(tb, st, x)
    B = counts.shape[0]
    karr = torch.arange(B, dtype=torch.int32, device=counts.device)
    if singleton:
        removed = cand_idx[None, :] == karr[:, None]
    else:
        removed = cand_idx[None, :] <= karr[:, None]
    return ffd_feasibility_core_plain(tb, rc, _lane_avail(avail0, removed), counts, sizes, with_left)


def _row0(xs: K.PodX) -> K.PodX:
    return K.PodX(*(Reqs(*(a[0] for a in f)) if isinstance(f, Reqs) else f[0] for f in xs))


def fast_sweep(
    tb: K.Tables, st: K.State, xs: K.PodX, avail0, cand_idx, counts, sizes, singleton=False, with_left=False
):
    """(feasible [B] bool, steps) of the delta-state sweep for the pod in
    row 0 of the batch `xs`, and the leftovers [B, C] with `with_left`.
    CPU tensors take the plain version; CUDA tensors launch K6."""
    if st.rank.device.type == "cpu":
        return fast_sweep_plain(tb, st, _row0(xs), avail0, cand_idx, counts, sizes, singleton, with_left)
    lanes = {"cand_idx": cand_idx, "counts": counts}
    out = launch_sweep(
        "fast_sweep", tb, st, xs, avail0, sizes, counts.shape[0], lanes, with_left, singleton=int(singleton)
    )
    LAUNCHES["fast_sweep_singleton" if singleton else "fast_sweep"] += 1
    return out


# ---------------------------------------------------------------------------
# the CUDA kernels' wrapper (K6 fast_sweep here, K8 set_sweep in
# setsweep.py: both take StepArgs for the tables, the base state and the
# representative pod, and SweepArgs for the lanes, csrc/sweep_core.cuh)


@functools.lru_cache(maxsize=None)
def sweep_library(name: str):
    """(library, StepArgs type, SweepArgs type) of a sweep kernel; the
    SweepArgs structure is built from the field names the library
    reports, as the StepArgs one is."""
    lib, args_type = K.step_library(name)
    getattr(lib, f"{name}_launch").argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    getattr(lib, f"{name}_sweep_field_names").restype = ctypes.c_char_p
    getattr(lib, f"{name}_sweep_args_size").restype = ctypes.c_int
    avail_words = getattr(lib, f"{name}_lane_avail_words")
    avail_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    avail_words.restype = ctypes.c_longlong
    ptrs, ints = getattr(lib, f"{name}_sweep_field_names")().decode().split("|")
    fields = [(n, ctypes.c_void_p) for n in ptrs.split(",") if n]
    fields += [(n, ctypes.c_int) for n in ints.split(",") if n]
    sweep_type = type("SweepArgs", (ctypes.Structure,), {"_fields_": fields})
    if ctypes.sizeof(sweep_type) != getattr(lib, f"{name}_sweep_args_size")():
        raise RuntimeError(f"{name}: SweepArgs layout disagrees with the library")
    return lib, args_type, sweep_type


def launch_sweep(name: str, tb, st, xs, avail0, sizes, B: int, lanes: dict, with_left=False, **ints):
    """Launch sweep kernel `name` over B lanes; `lanes` holds the kernel's
    own lane inputs (int32 tensors by SweepArgs field name), `ints` its
    int fields. Returns (feasible [B] bool, steps as a 0-dim tensor), and
    with `with_left` the leftovers [B, C] the kernel wrote. A lane keeps
    its availability in shared memory; where it does not fit there, the
    library asks for a device buffer of `<name>_lane_avail_words` words a
    lane, allocated here."""
    lib, args_type, sweep_type = sweep_library(name)
    dev = st.rank.device
    E, R = st.eavail.shape
    C = sizes.shape[0]
    vals = K.step_arg_values(tb, st, xs, dev)
    if tuple(avail0.shape) != (E, R) or tuple(sizes.shape[1:]) != (R,):
        raise ValueError(f"{name}: avail0 {tuple(avail0.shape)} / sizes {tuple(sizes.shape)} disagree with E={E}, R={R}")
    probe = K.step_args(name, args_type, vals)
    scratch = torch.empty(int(getattr(lib, f"{name}_scratch_bytes")(ctypes.byref(probe))), dtype=torch.uint8, device=dev)
    vals["scratch"] = scratch.data_ptr()
    feasible = torch.empty(B, dtype=torch.uint8, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    work = {
        "left": torch.empty((B, max(C, 1)), dtype=torch.int32, device=dev),
        "fit1": torch.empty((tb.tdaemon.shape[0], max(C, 1)), dtype=torch.uint8, device=dev),
    }
    sv = {"avail0": K.checked_ptr(avail0, torch.int32, dev, "avail0"), "sizes": K.checked_ptr(sizes, torch.int32, dev, "sizes")}
    sv["feasible"] = K.checked_ptr(feasible, torch.uint8, dev, "feasible")
    sv["steps"] = K.checked_ptr(steps, torch.int32, dev, "steps")
    for k, t in lanes.items():
        sv[k] = K.checked_ptr(t, torch.int32, dev, k)
    sv.update(B=B, C=C, **ints)
    names = [f for f, _ in sweep_type._fields_]
    unknown = set(sv) - set(names)
    if unknown:
        raise RuntimeError(f"{name}: sweep fields out of step with the library: {sorted(unknown)}")
    args = K.step_args(name, args_type, vals)
    words = int(getattr(lib, f"{name}_lane_avail_words")(ctypes.byref(args), ctypes.byref(sweep_type(**{
        f: sv.get(f, 0) for f in names}))))
    if words < 0:
        raise RuntimeError(f"{name}: the library could not size the lanes' shared memory")
    if words:
        work["avail"] = torch.empty((B, words), dtype=torch.int32, device=dev)
    for k, t in work.items():
        sv[k] = K.checked_ptr(t, t.dtype, dev, k)
    sargs = sweep_type(**{f: sv.get(f, 0) for f in names})
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = getattr(lib, f"{name}_launch")(ctypes.byref(args), ctypes.byref(sargs), ctypes.c_void_p(stream))
    _build.check_launch(name, code)
    if with_left:
        return feasible.bool(), steps[0], work["left"][:, :C]
    return feasible.bool(), steps[0]


# ---------------------------------------------------------------------------
# host guards and gates


def capacity_cumsum_fits_int32(eavail, sizes) -> bool:
    """Host-side int64 proof that the delta-state kernels' per-class
    capacity cumsum cannot wrap int32. The worst case is the BASE
    availability divided by the class size — removed slots only LOWER
    availability, so the bound is lane-independent and shared by every
    sweep scheme (prefix, singleton, arbitrary membership sets)."""
    avail64 = np.asarray(eavail).astype(np.int64)
    ok_rows = (avail64 >= 0).all(axis=1)
    for c in range(len(sizes)):
        s = np.asarray(sizes[c]).astype(np.int64)
        per = np.where(s > 0, avail64 // np.maximum(s, 1), 1 << 30)
        cap0 = np.where(ok_rows, np.maximum(per.min(axis=1), 0), 0)
        if int(cap0.sum()) >= (1 << 31):
            return False
    return True


def fast_gate_reason(problem) -> Optional[str]:
    """Why the delta-state fast shape does NOT apply to this union
    problem (None = it does). Shared with the removal-set sweep
    (setsweep.py), which supports exactly this shape: the prefix path
    falls back to its full-state lane scan on a reason, the set path
    raises SweepUnsupported with it."""
    p = problem
    if not _bulk_gates(p, strict_types=True):
        return "bulk gates fail (minValues/limits/daemon host ports/type structure)"
    if (p.ptopo_kind_c != 0).any() or p.pinv_h_c.any() or p.pown_h_c.any():
        return "topology constraints among union pods"
    if any(hg.inverse for hg in p.hgroups):
        return "inverse hostname groups (anti-affinity) in union problem"
    if len(p.rclass_creps) != 1:
        return "union pods span multiple requirement classes"
    return None


def fast_sweep_args(sched, problem, candidates, view_slot, order, pod_prefix, singleton=False):
    """K6's lane inputs for a union problem that passes the fast gates:
    (xs1, avail0, cand_idx, counts, sizes) on the scheduler's device, or
    None when the classes are not contiguous in FFD order or an int32
    guard fails (the caller takes the full-state lane scan)."""
    p = problem
    order_arr = np.asarray(order, dtype=np.int64)
    ordered_cls = p.pod_class[order_arr]
    class_seq = tp.contiguous_class_seq(ordered_cls)
    if class_seq is None:
        return None  # classes not contiguous in FFD order (sig collision)

    B = len(candidates)
    pp = np.asarray(pod_prefix)[order_arr]
    base, M = tp.group_class_counts(ordered_cls, class_seq, pp, B)
    # prefix lanes accumulate candidates[:k+1]'s pods; singleton lanes
    # carry only candidate k's
    counts = ((M + base[None]) if singleton else (np.cumsum(M, axis=0) + base[None])).astype(np.int32)
    sizes = p.prequests_c[class_seq].astype(np.int32)
    cand_idx = np.full(p.num_existing, (1 << 30), np.int32)
    for j, c in enumerate(candidates):
        cand_idx[view_slot[c.name]] = j

    # int32-exactness guards (host-side, int64): the kernel sums
    # left*sizes and cumsums per-node pod-unit capacities in int32 —
    # feasibility verdicts must never ride a wrapped total
    worst_tot = counts.max(axis=0).astype(np.int64) @ sizes.astype(np.int64)
    if (worst_tot >= (1 << 30)).any():
        return None
    if not capacity_cumsum_fits_int32(p.eavail, sizes):
        return None

    rep_i = p.class_reps[int(p.rclass_creps[0])]
    t = sched._t
    return sched._pod_xs(p, [rep_i]), t(p.eavail), t(cand_idx), t(counts), t(sizes)


def _fast_prefix_feasibility(
    sched, problem, candidates, view_slot, order, pod_prefix, tb, base_st, singleton=False,
):
    """Gate-check and run the delta-state sweep; None = the gates failed
    and the caller takes the full-state lane scan. tb/base_st come from
    the caller (the tables upload once per sweep)."""
    if fast_gate_reason(problem) is not None:
        return None
    if not len(order):
        return [True] * len(candidates)
    args = fast_sweep_args(sched, problem, candidates, view_slot, order, pod_prefix, singleton)
    if args is None:
        return None
    feasible, steps = fast_sweep(tb, base_st, *args, singleton=singleton)
    last_sweep.clear()
    last_sweep.update(path="sweep_fast", lanes=len(candidates), steps=int(steps))
    return [bool(v) for v in feasible.cpu().numpy()]


# ---------------------------------------------------------------------------
# the union problem


class UnionSweep:
    """One union problem shared by every batched removal scheme: all
    candidate nodes stay existing slots, all candidates' reschedulable
    pods (plus pending pods) are solve pods, tables uploaded once. Built
    by build_union; consumed by prefix_feasibility here and by
    setsweep.SetSweepContext."""

    __slots__ = ("sched", "problem", "pods", "pod_prefix", "order", "view_slot", "tb", "base")

    def __init__(self, sched, problem, pods, pod_prefix, order, view_slot, tb, base):
        self.sched = sched
        self.problem = problem
        self.pods = pods
        self.pod_prefix = pod_prefix
        self.order = order
        self.view_slot = view_slot
        self.tb = tb
        self.base = base


def build_union(kube, cluster, cloud_provider, candidates: list[Candidate], options=None, device=None) -> UnionSweep:
    """The shared front half of every batched sweep: the union gates
    (nodepool limits, draining non-candidates, missing views, host
    ports), the union problem encode, the shared FFD order and the one
    table upload per sweep. Raises SweepUnsupported on any gate."""
    node_pools = [np_ for np_ in kube.list("NodePool") if np_.replicas is None]
    if any(np_.limits for np_ in node_pools):
        raise SweepUnsupported("nodepool limits make per-prefix state diverge")
    # pods draining off OTHER deleting nodes are part of every sequential
    # simulation (helpers.py simulate_scheduling); their per-prefix
    # handling isn't modeled here
    candidate_names = {c.name for c in candidates}
    for sn in cluster.state_nodes():
        if sn.name in candidate_names:
            continue
        if sn.marked_for_deletion or sn.deleting():
            if any(is_reschedulable(pd) for pd in cluster.pods_on(sn.name)):
                raise SweepUnsupported("reschedulable pods draining off non-candidate nodes")
    its_by_pool = {np_.name: cloud_provider.get_instance_types(np_) for np_ in node_pools}
    daemonset_pods = [ds.pod_template for ds in kube.list("DaemonSet")]

    views = list(cluster.schedulable_node_views())
    view_slot = {v.name: e for e, v in enumerate(views)}
    missing = [c.name for c in candidates if c.name not in view_slot]
    if missing:
        raise SweepUnsupported(f"candidates missing from schedulable views: {missing}")

    pods = []
    pod_prefix = []  # pod i becomes valid from prefix index pod_prefix[i]
    for j, c in enumerate(candidates):
        for pod in c.reschedulable_pods:
            pods.append(pod.deep_copy())
            pod_prefix.append(j)
    for pod in kube.pending_pods():
        pods.append(pod.deep_copy())
        pod_prefix.append(-1)  # valid in every lane

    # full-cluster topology (all nodes, all bound pods)
    topology = Topology(
        node_pools, its_by_pool, pods, cluster=cluster_source(kube, cluster), state_node_views=views,
    )
    sched = TorchScheduler(
        node_pools,
        its_by_pool,
        topology,
        views,
        daemonset_pods,
        SchedulerOptions(timeout_seconds=getattr(options, "solve_timeout_seconds", None)),
        device=device,
    )
    try:
        problem = encode_problem(sched.oracle, pods)
    except UnsupportedBySolver as e:
        raise SweepUnsupported(str(e)) from e
    if problem.num_host_ports:
        # per-lane host-port usage deltas aren't modeled in the batched
        # construction; the sequential scans handle them exactly
        raise SweepUnsupported("host ports in sweep problem")

    # FFD order shared with the oracle
    from karpenter_tpu_torch.solver.ordering import ffd_sort_key

    data = sched.oracle.cached_pod_data
    for pod in pods:
        sched.oracle._update_cached_pod_data(pod)
    order = sorted(range(len(pods)), key=lambda i: ffd_sort_key(pods[i], data[pods[i].uid].requests))

    tb = sched._tables(problem)  # also sets sched._typeok
    sched._upload_pod_tables(problem)
    base = sched._init_state(problem, UNION_CLAIM_SLOTS)
    return UnionSweep(sched, problem, pods, pod_prefix, order, view_slot, tb, base)


# ---------------------------------------------------------------------------
# the entry points


def prefix_feasibility(
    kube, cluster, cloud_provider, candidates: list[Candidate], options=None, singleton: bool = False, device=None,
) -> list[bool]:
    """[len(candidates)] — feasible(k), all lanes evaluated in one device
    dispatch. Prefix mode (multi-node consolidation): lane k removes
    candidates[:k+1]. Singleton mode (single-node consolidation): lane k
    removes only candidates[k]."""
    B = len(candidates)
    if B == 0:
        return []
    if B > MAX_SWEEP_PREFIXES:
        raise SweepUnsupported(f"{B} prefixes > {MAX_SWEEP_PREFIXES}")

    u = build_union(kube, cluster, cloud_provider, candidates, options, device=device)
    fast = _fast_prefix_feasibility(
        u.sched, u.problem, candidates, u.view_slot, u.order, u.pod_prefix, u.tb, u.base, singleton=singleton,
    )
    if fast is not None:
        return fast
    # the fast gates failed: the full-state lane scan is exact but carries
    # B copies of the State, so large problems go to the sequential search
    if B * len(u.pods) > MAX_VMAP_LANE_PODS:
        raise SweepUnsupported("delta-state gates failed on a large problem; binary search wins")
    return _lane_scan_feasibility(cluster, candidates, u, singleton)


def _topology_deltas(cluster, candidates, u: UnionSweep):
    """Per candidate j, the zone-family and hostname-family count deltas
    (add_v, rm_v, add_h, rm_h; int64 [B, G, ...]) of its pods: the base
    topology excluded every union pod (they are solve pods), so lane k
    adds back the reschedulable pods of the candidates it keeps and
    removes the other pods (daemonset riders) of the ones it removes,
    replicating topology.py _count_domains (topology.go:328) per pod."""
    from karpenter_tpu_torch.scheduling import Requirements
    from karpenter_tpu_torch.solver.tpu_problem import TERMINAL_PHASES

    problem, base = u.problem, u.base
    B = len(candidates)
    slot_of = [u.view_slot[c.name] for c in candidates]
    Gv, VMAX = base.v_cnt.shape
    Gh, S = base.h_cnt.shape
    add_v = np.zeros((B, Gv, VMAX), np.int64)
    rm_v = np.zeros((B, Gv, VMAX), np.int64)
    add_h = np.zeros((B, Gh, S), np.int64)
    rm_h = np.zeros((B, Gh, S), np.int64)
    vocab = problem.vocab
    union_uids = {p.uid for p in u.pods}
    for j, c in enumerate(candidates):
        sn = cluster.node_by_name(c.name)
        node = sn.node if sn is not None else None
        labels = dict(node.metadata.labels) if node is not None else {}
        taints = list(node.taints) if node is not None else []
        label_reqs = Requirements.from_labels(labels)
        for pod in cluster.pods_on(c.name):
            if pod.phase in TERMINAL_PHASES or pod.terminating:
                continue
            resched = pod.uid in union_uids
            if pod.pod_anti_affinity:
                # anti-affinity pods on candidates create inverse hostname
                # groups whose per-lane counts this construction doesn't
                # restore
                raise SweepUnsupported("anti-affinity pod on candidate")
            for g, vg in enumerate(problem.vgroups):
                tg = vg.group
                if pod.namespace not in tg.namespaces:
                    continue
                if tg.selector is None or not tg.selector.matches(pod.metadata.labels):
                    continue
                dom = labels.get(tg.key)
                if dom is None:
                    continue
                if not tg.node_filter.matches(taints, label_reqs):
                    continue
                vid = vocab.value_index[vg.kid].get(dom)
                if vid is None:
                    continue
                (add_v if resched else rm_v)[j, g, vid] += 1
            for g, hg in enumerate(problem.hgroups):
                if hg.inverse:
                    continue  # gated above
                tg = hg.group
                if pod.namespace not in tg.namespaces:
                    continue
                if tg.selector is None or not tg.selector.matches(pod.metadata.labels):
                    continue
                if not tg.node_filter.matches(taints, label_reqs):
                    continue
                (add_h if resched else rm_h)[j, g, slot_of[j]] += 1
    return add_v, rm_v, add_h, rm_h


def lane_scan_args(cluster, candidates, u: UnionSweep, singleton: bool):
    """K7's inputs for the union: (st_b, xs, valid_b, lane_pods, relax) —
    every lane's State (its removed slots at -1, its topology counts
    restored by the per-candidate deltas), the shared pod batch in FFD
    order, the [B, P] valid rows and, per lane, which of the ordered pods
    are its own."""
    sched, problem, base = u.sched, u.problem, u.base
    B = len(candidates)
    slot_of = [u.view_slot[c.name] for c in candidates]
    add_v, rm_v, add_h, rm_h = _topology_deltas(cluster, candidates, u)
    tot_add_v = add_v.sum(axis=0)
    tot_add_h = add_h.sum(axis=0)

    base_eavail = base.eavail.cpu().numpy()
    base_v = base.v_cnt.cpu().numpy().astype(np.int64)
    base_h = base.h_cnt.cpu().numpy().astype(np.int64)
    eavail_b = np.broadcast_to(base_eavail, (B,) + base_eavail.shape).copy()
    if singleton:
        for k in range(B):
            eavail_b[k, slot_of[k], :] = -1  # only candidate k removed
        v_cnt_b = base_v[None] + (tot_add_v[None] - add_v) - rm_v
        h_cnt_b = base_h[None] + (tot_add_h[None] - add_h) - rm_h
    else:
        for k in range(B):
            for j in range(k + 1):
                eavail_b[k, slot_of[j], :] = -1  # removed: fits nothing
        v_cnt_b = base_v[None] + (tot_add_v[None] - np.cumsum(add_v, axis=0)) - np.cumsum(rm_v, axis=0)
        h_cnt_b = base_h[None] + (tot_add_h[None] - np.cumsum(add_h, axis=0)) - np.cumsum(rm_h, axis=0)

    # int64 guard before the int32 device cast: a per-lane count that
    # cannot ride the kernel's int32 topology state goes to the sequential
    # scans, never wraps
    peak = max(int(np.abs(v_cnt_b).max(initial=0)), int(np.abs(h_cnt_b).max(initial=0)))
    if peak >= (1 << 31):
        raise SweepUnsupported("per-prefix topology counts exceed int32")

    order = u.order
    xs = sched._pod_xs(problem, order)
    P_pad = int(xs.valid.shape[0])
    pp = np.asarray([u.pod_prefix[i] for i in order])
    lane_pods = np.zeros((B, len(order)), bool)
    for k in range(B):
        lane_pods[k] = ((pp == k) | (pp < 0)) if singleton else (pp <= k)
    valid_b = np.zeros((B, P_pad), bool)
    valid_b[:, : len(order)] = lane_pods

    t = sched._t
    st_b = K.stack_lanes([base] * B)._replace(
        eavail=t(eavail_b), v_cnt=t(v_cnt_b.astype(np.int32)), h_cnt=t(h_cnt_b.astype(np.int32)),
    )
    return st_b, xs, t(valid_b), lane_pods, bool((problem.ntiers_r > 1).any())


def _lane_scan_feasibility(cluster, candidates, u: UnionSweep, singleton: bool) -> list[bool]:
    """The full-state lane scan (the reference's `vmap(solve_scan)` path,
    kernel K7 on the card): every lane walks the union's pods over its own
    State; a lane is feasible when none of its pods fails, no claim slot
    overflows and at most one claim opens."""
    st_b, xs, valid_b, lane_pods, relax = lane_scan_args(cluster, candidates, u, singleton)
    st_out, kinds, _, over, odo = K.scan_lanes(u.tb, st_b, xs, valid_b, relax)
    kinds = kinds.cpu().numpy()[:, : lane_pods.shape[1]]
    over = over.cpu().numpy()
    n_claims = st_out.n_claims.cpu().numpy()
    last_sweep.clear()
    last_sweep.update(path="sweep_vmap", lanes=len(candidates), steps=int(odo.steps.sum()))
    return [
        not bool(over[k]) and int(n_claims[k]) <= 1 and not np.any((kinds[k] == K.KIND_FAIL) & lane_pods[k])
        for k in range(len(candidates))
    ]


def singleton_feasibility(
    kube, cluster, cloud_provider, candidates: list[Candidate], options=None, device=None,
) -> list[bool]:
    """[len(candidates)] — can candidate k alone be removed with all its
    pods rescheduling onto the remaining cluster plus at most one new
    node? Every candidate is an independent lane."""
    return prefix_feasibility(kube, cluster, cloud_provider, candidates, options, singleton=True, device=device)


def sweep_first_n(consolidation, candidates: list[Candidate]):
    """MultiNodeConsolidation's prefix search ("batched" rung): one batched
    feasibility sweep on `consolidation.device`, then the real
    compute_consolidation on the largest feasible prefix (prices and spot
    rules as the sequential path's). Returns a Command."""
    from karpenter_tpu_torch.controllers.disruption.types import Command

    feasible = prefix_feasibility(
        consolidation.kube,
        consolidation.cluster,
        consolidation.cloud,
        candidates,
        consolidation.opts,
        device=consolidation.device,
    )
    for k in range(len(candidates), 0, -1):
        if not feasible[k - 1]:
            continue
        cmd = consolidation.compute_consolidation(candidates[:k])
        if cmd.decision != "no-op":
            return cmd
    return Command(reason=consolidation.reason)
