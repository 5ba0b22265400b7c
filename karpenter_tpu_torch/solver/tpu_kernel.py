"""The greedy-packing step: one pod's exact FFD decision and commit.

A port of the reference's `solver/tpu_kernel.py`. It reproduces the
oracle's decision sequence exactly: existing nodes in fixed order, then
in-flight claims in stable-sorted (pod-count, attainment-order) rank with an
exact per-claim type verify in rank order, then a new claim from the first
feasible template in weight order. With `relax`, a pod with a preference
ladder tries its tiers in order inside its own step (`_step_relax`), each
tier against the state before the pod.

Two versions of the same function live here:

- the plain version (`_step`, `_step_relax`, `solve_scan_plain`): torch
  tensor code that mirrors the reference line for line, vectorized over
  candidates. The CPU tests hold it against the JAX package; on the card
  it is the yardstick the kernel is compared with.
- the CUDA kernel `scan_step` (csrc/scan_step.cu), launched by
  `solve_scan` for CUDA tensors. One persistent single-CTA launch walks the
  whole pod batch in order; per pod, `__syncthreads()` separates the
  existing-node screen, the claim screen, the exact verify loop, the
  template branch and the commit. State is updated in place in device
  memory (a few MB at the headline size, resident in L2). With `relax`,
  the step runs inside the tier loop (`relax_step` in csrc/step.cuh).

  Replaces: karpenter_tpu/solver/tpu_kernel.py:560 `_step`, :931
  `solve_scan`, and the tier loop :872 `_x_at_tier`, :898 `_step_relax`,
  :107 `odo_tier_tick`.
  Bound on an H100: by bytes, the state and tables it must read per pod
  (claim rows dominate: N x (2 TW + 3 K) words); in practice the pod
  sequence is a dependent chain of small reductions, so launch-free
  latency per pod, not bandwidth, decides its time. The design keeps the
  whole batch in one launch (no host round trip per pod) and spreads each
  pod's candidate screens over the CTA's threads.

Bit words are int32 (device.py). Every scatter whose index may fall past
the array (the new-claim slot m == N) is guarded, and every gather the
reference leaves to XLA's clamping is clamped explicitly.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional

import torch

from karpenter_tpu_torch import _build
from karpenter_tpu_torch.analysis import runtime as budgets
from karpenter_tpu_torch.device import gather_bits, pack, unpack
from karpenter_tpu_torch.ops.encode import GT_NONE, LT_NONE, Reqs
from karpenter_tpu_torch.ops.kernels import (
    VocabArrays,
    bitwise_or_reduce,
    compat,
    intersect,
    intersects_only,
    seg_any,
    seg_popcount,
)
from karpenter_tpu_torch.solver.tpu_problem import (
    MAX_RELAX_TIERS,
    TOPO_AFFINITY_H,
    TOPO_AFFINITY_V,
    TOPO_ANTI_V,
    TOPO_NONE,
    TOPO_SPREAD_H,
    TOPO_SPREAD_V,
)

INF_I = 1 << 30

KIND_EXISTING = 0
KIND_CLAIM = 1
KIND_NEW = 2
KIND_FAIL = 3

# launches of the CUDA step kernels (one per solve_scan / scan_lanes /
# solve_scan_lanes call on the card), counted apart for launches with the
# relax tier loop on; K7 counts the sweep's launches (scan_lanes) apart
# from the fleet's (fleet_lanes)
LAUNCHES = {
    "scan_step": 0, "scan_step_relax": 0, "scan_lanes": 0, "scan_lanes_relax": 0,
    "fleet_lanes": 0, "fleet_lanes_relax": 0,
}

# relax-tier odometer bins: a pod's trips at tier t land in bin
# min(t, ODO_TIER_BINS - 1) (the reference's layout)
ODO_TIER_BINS = 8


class Tables(NamedTuple):
    """Static (per-solve) tensors; the reference's layout and field names."""

    va: VocabArrays
    # templates [T]
    treq: Reqs
    tdaemon: torch.Tensor  # [T, R]
    ttypes: torch.Tensor  # [T, IW] words
    tlimit_def: torch.Tensor  # [T, R] bool
    thas_limits: torch.Tensor  # [T] bool
    # instance types [I]
    ireq: Reqs
    ialloc: torch.Tensor  # [I, R]
    icap: torch.Tensor  # [I, R]
    # offerings [O]; ovalid=False rows are bucket padding
    otype: torch.Tensor  # [O]
    oword: torch.Tensor  # [O, 3]
    obit: torch.Tensor  # [O, 3]
    ovalid: torch.Tensor  # [O] bool
    orid: torch.Tensor  # [O] reservation index, -1 = none
    # zone-family groups [Gv, VMAX]
    v_kid: torch.Tensor
    v_word: torch.Tensor
    v_bit: torch.Tensor
    v_reg: torch.Tensor
    v_skew: torch.Tensor
    v_mindom: torch.Tensor
    v_filt: torch.Tensor  # [Gv, 2]
    v_anti: torch.Tensor  # [Gv] bool
    # hostname-family groups [Gh]
    h_skew: torch.Tensor
    h_filt: torch.Tensor  # [Gh, 2]
    h_inverse: torch.Tensor  # [Gh] bool
    # node filters [F]
    filter_reqs: Reqs
    # template daemonset host-port seeds [T, HPW] words (zero-width if none)
    thp: torch.Tensor
    # relaxation-tier tables [NRx, L, ...] per relaxable requirement class
    # and tier (rows past the real NRx are bucket padding, never gathered)
    rt_preq: Reqs
    rt_typeok: torch.Tensor
    rt_tol_t: torch.Tensor
    rt_tol_e: torch.Tensor
    rt_kind: torch.Tensor
    rt_gid: torch.Tensor
    rt_sel: torch.Tensor


class State(NamedTuple):
    """Carried solver state."""

    # claims [N]
    active: torch.Tensor
    count: torch.Tensor
    rank: torch.Tensor
    tmpl: torch.Tensor
    creq: Reqs
    crequests: torch.Tensor  # [N, R]
    alive: torch.Tensor  # [N, IW] words
    cmax_alloc: torch.Tensor  # [N, R]
    n_claims: torch.Tensor  # 0-dim int32
    # existing nodes [E]
    ereq: Reqs
    eavail: torch.Tensor  # [E, R]
    # per-template remaining limits [T, R]
    trem: torch.Tensor
    # topology counts
    v_cnt: torch.Tensor  # [Gv, VMAX]
    h_cnt: torch.Tensor  # [Gh, S]  S = E + N
    # reserved capacity (zero-width when there are no reservations)
    rescap: torch.Tensor  # [NRES]
    held: torch.Tensor  # [N, NRESW] words
    # host-port usage per slot [S, HPW] words
    hp_used: torch.Tensor


class PodX(NamedTuple):
    """Per-pod scan inputs (batched [P, ...] for solve_scan)."""

    preq: Reqs
    prequests: torch.Tensor  # [R]
    typeok: torch.Tensor  # [IW] words — types whose reqs intersect the pod's
    tol_t: torch.Tensor  # [T]
    tol_e: torch.Tensor  # [E]
    topo_kind: torch.Tensor  # [C]
    topo_gid: torch.Tensor  # [C]
    topo_sel: torch.Tensor  # [C]
    sel_v: torch.Tensor  # [Gv]
    sel_h: torch.Tensor  # [Gh]
    inv_h: torch.Tensor  # [Gh]
    own_h: torch.Tensor  # [Gh]
    valid: torch.Tensor  # 0-dim bool
    rrow: torch.Tensor  # 0-dim int32
    ntiers: torch.Tensor  # 0-dim int32
    hp_own: torch.Tensor  # [HPW] words
    hp_conf: torch.Tensor  # [HPW] words


class Odometer(NamedTuple):
    """Device-truth counters a dispatch returns beside its results, as
    0-dim int32 tensors (tier_hist [ODO_TIER_BINS]). Write-only: no
    decision reads them.

    - steps: loop iterations executed (pod positions on the scan path, pads
      included; pointer-loop trips on the runs path);
    - bulk_steps: runs-path bulk-window trips (a subset of steps);
    - tier_steps, tier_hist: relax tier-loop trips (each trip one full
      step; 0 with relax off); see `odo_tier_tick`.
    """

    steps: torch.Tensor
    bulk_steps: torch.Tensor
    tier_steps: torch.Tensor
    tier_hist: torch.Tensor


def odometer(steps, bulk_steps, dev, tier_steps=0, tier_hist=None) -> Odometer:
    """An Odometer from step counts (ints or tensors) on `dev`."""
    if tier_hist is None:
        tier_hist = [0] * ODO_TIER_BINS
    return Odometer(
        steps=torch.as_tensor(steps, dtype=torch.int32, device=dev),
        bulk_steps=torch.as_tensor(bulk_steps, dtype=torch.int32, device=dev),
        tier_steps=torch.as_tensor(tier_steps, dtype=torch.int32, device=dev),
        tier_hist=torch.as_tensor(tier_hist, dtype=torch.int32, device=dev),
    )


def tier_tick(tier_steps: int, tier_hist: list, trips: int) -> int:
    """Credit one pod's `trips` tier-loop trips (the reference's
    `odo_tier_tick`): bins 0..ODO_TIER_BINS-2 count the pods whose trips
    exceed the bin index, the last bin takes max(trips - its index, 0).
    Updates `tier_hist` in place; returns the new tier_steps."""
    last = ODO_TIER_BINS - 1
    for b in range(last):
        tier_hist[b] += int(trips > b)
    tier_hist[last] += max(trips - last, 0)
    return tier_steps + trips


def _row(r: Reqs, i) -> Reqs:
    return Reqs(*(a[i] for a in r))


def _reqs_where(c, a: Reqs, b: Reqs) -> Reqs:
    return Reqs(*(torch.where(c[..., None], x, y) for x, y in zip(a, b)))


def _set_row(dst: Reqs, i, row: Reqs, pred) -> None:
    """In place: dst[i] = row where pred (i must be in range)."""
    for a, v in zip(dst, row):
        a[i] = torch.where(pred, v, a[i])


def _broadcast_row(r: Reqs, n: int) -> Reqs:
    return Reqs(*(a.expand((n,) + a.shape) for a in r))


def _i32(v, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# topology evaluation


class TopoEval(NamedTuple):
    viable: torch.Tensor  # [B]
    tight: torch.Tensor  # [B, TW] mask to AND in
    touched: torch.Tensor  # [K] keys tightened by zone-family constraints


def _first_true(b: torch.Tensor) -> torch.Tensor:
    """argmax of a bool tensor along the last dim (0 when none is set)."""
    return torch.argmax(b.to(torch.int32), dim=-1)


def _eval_topology(merged: Reqs, slot_cnt_h, nonempty_h, x: PodX, st: State, tb: Tables) -> TopoEval:
    dev = merged.mask.device
    B = merged.mask.shape[0]
    TW = merged.mask.shape[-1]
    Gv = tb.v_reg.shape[0]
    K = tb.va.num_keys
    viable = torch.ones(B, dtype=torch.bool, device=dev)
    tight = tb.va.full_mask.expand(B, TW)
    touched = torch.zeros(K, dtype=torch.bool, device=dev)
    inf = _i32(INF_I, dev)
    ones_w = _i32(-1, dev)  # 0xFFFFFFFF

    # inverse anti-affinity applies to any selected pod
    inv_bad = torch.any(x.inv_h[:, None] & (slot_cnt_h > 0), dim=0)
    viable = viable & ~inv_bad

    for c in range(x.topo_kind.shape[0]):
        kind = x.topo_kind[c]
        gid = x.topo_gid[c]
        selfsel = x.topo_sel[c].to(torch.int32)

        # zone-family quantities (safe even when kind is hostname)
        gv = gid.clamp(0, max(Gv - 1, 0)).long()
        words = tb.v_word[gv]
        bitsp = tb.v_bit[gv]
        reg = tb.v_reg[gv]
        cnt = st.v_cnt[gv]
        skew = tb.v_skew[gv]
        node_bits = gather_bits(merged.mask, words, bitsp)  # [B, VMAX]
        pod_dom = gather_bits(x.preq.mask, words, bitsp)  # [VMAX]
        eff = cnt + selfsel
        vmax = words.shape[0]
        vidx = torch.arange(vmax, device=dev)

        # spread: min over pod-supported registered domains; first domain
        # (lowest value id) holding the minimum count
        sup = reg & pod_dom
        min_cnt = torch.min(torch.where(sup, cnt, inf))
        n_sup = sup.to(torch.int32).sum()
        mindom = tb.v_mindom[gv]
        min_cnt = torch.where((mindom >= 0) & (n_sup < mindom), _i32(0, dev), min_cnt)
        cand_s = node_bits & reg
        ok_s = cand_s & (eff - min_cnt <= skew)
        best_eff = torch.min(torch.where(ok_s, eff, inf), dim=-1, keepdim=True).values
        spread_viable = torch.any(ok_s, dim=-1)
        first = _first_true(ok_s & (eff == best_eff))
        spread_bits = (vidx == first[:, None]) & spread_viable[:, None]

        # affinity
        pos = reg & (cnt > 0)
        aff_set = node_bits & pos & pod_dom
        aff_direct = torch.any(aff_set, dim=-1)
        nonempty_total = torch.any(pos)
        any_compat = torch.any(pos & pod_dom)
        bootstrap = (selfsel > 0) & (~nonempty_total | ~any_compat)
        b_cand = reg & pod_dom & node_bits
        b_first = _first_true(b_cand)
        b_ok = torch.any(b_cand, dim=-1) & bootstrap
        b_bits = (vidx == b_first[:, None]) & b_ok[:, None]
        aff_viable = aff_direct | b_ok
        aff_bits = torch.where(aff_direct[:, None], aff_set, b_bits)

        # anti: only empty registered domains
        anti_bits = reg & (cnt == 0) & node_bits & pod_dom
        anti_viable = torch.any(anti_bits, dim=-1)

        # hostname-family
        gh_cnt = slot_cnt_h[gid.clamp(0, slot_cnt_h.shape[0] - 1).long()]  # [B]
        h_skew = tb.h_skew[gid.clamp(0, tb.h_skew.shape[0] - 1).long()]
        h_ne = nonempty_h[gid.clamp(0, nonempty_h.shape[0] - 1).long()]
        hs_viable = gh_cnt + selfsel <= h_skew
        ha_viable = (gh_cnt > 0) | ((selfsel > 0) & ~h_ne)
        hanti_viable = gh_cnt == 0

        is_v = (kind == TOPO_SPREAD_V) | (kind == TOPO_AFFINITY_V) | (kind == TOPO_ANTI_V)
        c_viable = torch.where(
            kind == TOPO_NONE,
            torch.ones_like(hanti_viable),
            torch.where(
                kind == TOPO_SPREAD_V,
                spread_viable,
                torch.where(
                    kind == TOPO_AFFINITY_V,
                    aff_viable,
                    torch.where(
                        kind == TOPO_ANTI_V,
                        anti_viable,
                        torch.where(
                            kind == TOPO_SPREAD_H,
                            hs_viable,
                            torch.where(kind == TOPO_AFFINITY_H, ha_viable, hanti_viable),
                        ),
                    ),
                ),
            ),
        )
        viable = viable & c_viable

        c_bits = torch.where(
            kind == TOPO_SPREAD_V,
            spread_bits,
            torch.where(kind == TOPO_AFFINITY_V, aff_bits, anti_bits),
        )  # [B, VMAX]
        # fold the allowed set into a [B, TW] word mask for the group's key
        kid = tb.v_kid[gv]
        in_seg = tb.va.word2key == kid  # [TW]
        vals = torch.where(words >= 0, c_bits.to(torch.int32) << bitsp, _i32(0, dev))
        delta = torch.zeros((B, TW), dtype=torch.int32, device=dev)
        delta.index_add_(1, words.clamp(min=0).long(), vals)
        seg_tight = torch.where(in_seg & is_v, delta, ones_w)
        tight = tight & seg_tight
        touched = touched | (is_v & (torch.arange(K, device=dev) == kid))

    return TopoEval(viable=viable, tight=tight, touched=touched)


def _apply_tighten(merged: Reqs, te_tight, touched, va: VocabArrays) -> Reqs:
    """Intersect merged reqs with the topology domain choices (an In set per
    touched key): concrete result, defined, no bounds change."""
    touched_w = touched[..., va.word2key]
    return Reqs(
        mask=merged.mask & te_tight,
        exmask=torch.where(touched_w, torch.zeros_like(merged.exmask), merged.exmask),
        other=merged.other & ~touched,
        notin=merged.notin & ~touched,
        defined=merged.defined | touched,
        gt=merged.gt,
        lt=merged.lt,
        minv=merged.minv,
    )


def _topo_nonempty_ok(final: Reqs, touched, va: VocabArrays) -> torch.Tensor:
    """Every touched key keeps a nonempty allowed set."""
    seg = seg_any(final.mask != 0, va)
    return ~torch.any(touched & ~seg, dim=-1)


# ---------------------------------------------------------------------------
# instance-type exact filtering


def _type_filter(final: Reqs, alive_bits, total, tb: Tables) -> torch.Tensor:
    """[I] bool — compat ∧ fits ∧ offering ∧ alive (one final row)."""
    I = tb.ireq.mask.shape[0]
    t_ok = intersects_only(tb.ireq, _broadcast_row(final, I), tb.va)
    fits = torch.all(total <= tb.ialloc, dim=-1)
    ow = tb.oword
    off_bit = gather_bits(final.mask, ow, tb.obit)  # [O, 3]
    off_ok = torch.all(off_bit | (ow < 0), dim=-1) & tb.ovalid
    off_any = torch.zeros(I, dtype=torch.int32, device=ow.device)
    inb = (tb.otype >= 0) & (tb.otype < I)
    off_any.index_add_(0, tb.otype.clamp(0, max(I - 1, 0)).long(), (off_ok & inb).to(torch.int32))
    return alive_bits & t_ok & fits & (off_any > 0)


def _min_values_ok(final: Reqs, final_i, tb: Tables) -> torch.Tensor:
    if not bool(torch.any(final.minv >= 0)):
        return torch.ones((), dtype=torch.bool, device=final_i.device)
    # SatisfiesMinValues unions `requirement.values` per key: concrete rows
    # contribute their allowed set, complements their excluded set,
    # undefined keys nothing
    w2k = tb.va.word2key
    zero = torch.zeros((), dtype=torch.int32, device=final_i.device)
    src = torch.where(tb.ireq.other[..., w2k], tb.ireq.exmask, tb.ireq.mask)
    src = torch.where(tb.ireq.defined[..., w2k], src, zero)
    union = bitwise_or_reduce(torch.where(final_i[:, None], src, zero), 0)
    counts = seg_popcount(union, tb.va)
    return torch.all((final.minv < 0) | (counts >= final.minv))


# ---------------------------------------------------------------------------
# stable-rank updates


def _rank_after_increment(st: State, j):
    cnew = st.count[j] + 1
    idx = torch.arange(st.rank.shape[0], device=st.rank.device)
    geq = st.active & (st.count >= cnew) & (idx != j)
    inf = _i32(INF_I, st.rank.device)
    boundary = torch.minimum(torch.min(torch.where(geq, st.rank, inf)), st.n_claims)
    rank = st.rank - ((st.rank > st.rank[j]) & (st.rank < boundary)).to(torch.int32)
    rank[j] = boundary - 1
    return rank, cnew


def _rank_after_create(st: State, m):
    geq2 = st.active & (st.count >= 2)
    inf = _i32(INF_I, st.rank.device)
    boundary = torch.minimum(torch.min(torch.where(geq2, st.rank, inf)), st.n_claims)
    rank = st.rank + (st.active & (st.rank >= boundary)).to(torch.int32)
    if m < rank.shape[0]:
        rank[m] = boundary
    return rank


# ---------------------------------------------------------------------------
# record (topology.go Record)


def _eval_filters(filt, final: Reqs, tb: Tables, allow_wk) -> torch.Tensor:
    """[G] bool — node_filter.matches(final reqs) over the alternatives."""
    G = filt.shape[0]
    dev = filt.device
    if tb.filter_reqs.mask.shape[0] == 0:
        return torch.ones(G, dtype=torch.bool, device=dev)
    ok = torch.zeros(G, dtype=torch.bool, device=dev)
    trivial = torch.all(filt < 0, dim=-1)
    F = tb.filter_reqs.mask.shape[0]
    for a in range(filt.shape[1]):
        alt = filt[:, a]
        rows = _row(tb.filter_reqs, alt.clamp(0, F - 1).long())
        final_b = _broadcast_row(final, G)
        got_strict = compat(final_b, rows, tb.va, False)
        got_allow = compat(final_b, rows, tb.va, True)
        got = torch.where(allow_wk, got_allow, got_strict)
        ok = ok | ((alt >= 0) & got)
    return trivial | ok


def _record(st_v_cnt, st_h_cnt, final: Reqs, slot_global: int, allow_wk, pred, x: PodX, tb: Tables):
    K = tb.va.num_keys
    segbits = gather_bits(final.mask, tb.v_word, tb.v_bit)  # [Gv, VMAX]
    exbits = gather_bits(final.exmask, tb.v_word, tb.v_bit)
    other_k = final.other[tb.v_kid.clamp(0, K - 1).long()]  # [Gv]
    popc = segbits.to(torch.int32).sum(-1)
    single = (popc == 1) & ~other_k
    filt_ok = _eval_filters(tb.v_filt, final, tb, allow_wk)
    add = torch.where(
        tb.v_anti[:, None],
        torch.where(other_k[:, None], exbits, segbits),
        segbits & single[:, None],
    )
    gate_v = (pred & x.sel_v & filt_ok)[:, None]
    v_cnt = st_v_cnt + (add & gate_v).to(torch.int32)

    filt_ok_h = _eval_filters(tb.h_filt, final, tb, allow_wk)
    contrib = torch.where(tb.h_inverse, x.own_h, x.sel_h & filt_ok_h)
    h_cnt = st_h_cnt
    if slot_global < h_cnt.shape[1]:  # out-of-range slots record nothing
        h_cnt = h_cnt.clone()
        h_cnt[:, slot_global] += (pred & contrib).to(torch.int32)
    return v_cnt, h_cnt


# ---------------------------------------------------------------------------
# the step


def _claim_screen(tb: Tables, st: State, x: PodX, nonempty_h):
    """(final_c, cand_c): every claim's merged+tightened row and whether it
    passes the screens (requirements, topology, fits bound, type screen,
    template tolerations, host ports)."""
    E = st.eavail.shape[0]
    N = st.active.shape[0]
    T = tb.tdaemon.shape[0]
    merged_c = intersect(st.creq, _broadcast_row(x.preq, N), tb.va)
    compat_c = compat(st.creq, _broadcast_row(x.preq, N), tb.va, True)
    te_c = _eval_topology(merged_c, st.h_cnt[:, E:], nonempty_h, x, st, tb)
    final_c = _apply_tighten(merged_c, te_c.tight, te_c.touched, tb.va)
    screen_fits = torch.all(st.crequests + x.prequests <= st.cmax_alloc, dim=-1)
    # pod-vs-type pairwise screen: a claim with no surviving type the pod
    # could use is never a candidate
    screen_types = torch.any((st.alive & x.typeok) != 0, dim=-1)
    cand_c = (
        st.active
        & x.tol_t[st.tmpl.clamp(0, max(T - 1, 0)).long()]
        & compat_c
        & te_c.viable
        & _topo_nonempty_ok(final_c, te_c.touched, tb.va)
        & screen_fits
        & screen_types
    )
    if st.hp_used.shape[1]:
        cand_c = cand_c & ~torch.any((x.hp_conf[None, :] & st.hp_used[E:]) != 0, dim=-1)
    return final_c, cand_c


def _step(tb: Tables, st: State, x: PodX):
    """One pod: returns (new_state, (kind, out_slot, overflow)); the input
    state is not modified."""
    dev = st.rank.device
    E = st.eavail.shape[0]
    N = st.active.shape[0]
    T = tb.tdaemon.shape[0]
    I = tb.ialloc.shape[0]
    IW = st.alive.shape[1]
    HPW = st.hp_used.shape[1]
    inf = _i32(INF_I, dev)
    valid = bool(x.valid)
    n_claims = int(st.n_claims)

    nonempty_h = torch.any(st.h_cnt > 0, dim=-1)  # [Gh]

    # ======== existing nodes (exact, fixed order) ========
    found_e, slot_e, final_e = False, 0, None
    if E > 0:
        merged_e = intersect(st.ereq, _broadcast_row(x.preq, E), tb.va)
        compat_e = compat(st.ereq, _broadcast_row(x.preq, E), tb.va, False)
        fits_e = torch.all(st.eavail >= 0, dim=-1) & torch.all(x.prequests <= st.eavail, dim=-1)
        te_e = _eval_topology(merged_e, st.h_cnt[:, :E], nonempty_h, x, st, tb)
        final_e = _apply_tighten(merged_e, te_e.tight, te_e.touched, tb.va)
        cand_e = x.tol_e & compat_e & fits_e & te_e.viable & _topo_nonempty_ok(final_e, te_e.touched, tb.va)
        if HPW:
            cand_e = cand_e & ~torch.any((x.hp_conf[None, :] & st.hp_used[:E]) != 0, dim=-1)
        found_e = bool(torch.any(cand_e)) and valid
        slot_e = int(torch.argmin(torch.where(cand_e, torch.arange(E, device=dev, dtype=torch.int32), inf)))

    # ======== in-flight claims (screen + exact loop in rank order) ========
    done = found_e or not valid
    excluded = torch.zeros(N, dtype=torch.bool, device=dev)
    slot_c = 0
    alive_cn = None
    final_c = None
    if not done:
        final_c, cand_c = _claim_screen(tb, st, x, nonempty_h)
    while not done:
        live = cand_c & ~excluded
        if not bool(torch.any(live)):
            break
        n = int(torch.argmin(torch.where(live, st.rank, inf)))
        final_n = _row(final_c, n)
        total = st.crequests[n] + x.prequests
        final_i = _type_filter(final_n, unpack(st.alive[n], I), total, tb)
        ok = bool(torch.any(final_i)) and bool(_min_values_ok(final_n, final_i, tb))
        excluded[n] = not ok
        done = ok
        slot_c = n if ok else 0
        if ok:
            alive_cn = final_i
    found_c = alive_cn is not None and not found_e and valid

    # ======== new claim from a template (exact, weight order) ========
    need_new = not found_e and not found_c and valid
    found_t, slot_t, overflow = False, 0, False
    final_tn, alive_tn = None, None
    if need_new:
        merged_t = intersect(tb.treq, _broadcast_row(x.preq, T), tb.va)
        compat_t = compat(tb.treq, _broadcast_row(x.preq, T), tb.va, True)
        # a fresh claim's hostname counts are always zero
        te_t = _eval_topology(
            merged_t,
            torch.zeros((st.h_cnt.shape[0], T), dtype=st.h_cnt.dtype, device=dev),
            nonempty_h,
            x,
            st,
            tb,
        )
        final_t = _apply_tighten(merged_t, te_t.tight, te_t.touched, tb.va)
        lim_ok = torch.all(
            ~tb.tlimit_def[:, None, :] | (tb.icap[None, :, :] <= st.trem[:, None, :]),
            dim=-1,
        )  # [T, I]
        tmember = unpack(tb.ttypes, I)  # [T, I]
        talive = tmember & (lim_ok | ~tb.thas_limits[:, None])
        totals = tb.tdaemon + x.prequests  # [T, R]
        t_final_i = torch.stack(
            [_type_filter(_row(final_t, t), talive[t], totals[t], tb) for t in range(T)]
        )
        t_minok = torch.stack(
            [_min_values_ok(_row(final_t, t), t_final_i[t], tb) for t in range(T)]
        )
        viable_nogate = (
            compat_t
            & te_t.viable
            & _topo_nonempty_ok(final_t, te_t.touched, tb.va)
            & x.tol_t
            & torch.any(t_final_i, dim=-1)
            & t_minok
        )
        if HPW:
            viable_nogate = viable_nogate & ~torch.any((x.hp_conf[None, :] & tb.thp) != 0, dim=-1)
        any_viable = bool(torch.any(viable_nogate))
        if any_viable and n_claims < N:
            found_t = True
            slot_t = int(torch.argmax(viable_nogate.to(torch.int32)))
            final_tn = _row(final_t, slot_t)
            alive_tn = t_final_i[slot_t]
        # a viable template exists but every claim slot is taken: the host
        # must re-solve with more slots
        overflow = any_viable and n_claims >= N

    if found_e:
        kind = KIND_EXISTING
    elif found_c:
        kind = KIND_CLAIM
    elif found_t:
        kind = KIND_NEW
    else:
        kind = KIND_FAIL

    # ======== apply updates (on copies; the input state stays intact) ========
    st2 = _clone_state(st)
    final_rec = None
    slot_global = 0
    if kind == KIND_EXISTING:
        st2.eavail[slot_e] -= x.prequests
        final_rec = _row(final_e, slot_e)
        _set_row(st2.ereq, slot_e, final_rec, torch.ones((), dtype=torch.bool, device=dev))
        slot_global = slot_e
    elif kind == KIND_CLAIM:
        final_rec = _row(final_c, slot_c)
        rank_inc, cnew = _rank_after_increment(st, slot_c)
        _set_row(st2.creq, slot_c, final_rec, torch.ones((), dtype=torch.bool, device=dev))
        st2.crequests[slot_c] += x.prequests
        st2.alive[slot_c] = pack(alive_cn, IW)
        st2.cmax_alloc[slot_c] = torch.max(torch.where(alive_cn[:, None], tb.ialloc, -inf), dim=0).values
        st2.count[slot_c] = cnew
        st2.rank.copy_(rank_inc)
        slot_global = E + slot_c
    elif kind == KIND_NEW:
        m = n_claims
        final_rec = final_tn
        _set_row(st2.creq, m, final_tn, torch.ones((), dtype=torch.bool, device=dev))
        st2.crequests[m] = tb.tdaemon[slot_t] + x.prequests
        st2.alive[m] = pack(alive_tn, IW)
        st2.cmax_alloc[m] = torch.max(torch.where(alive_tn[:, None], tb.ialloc, -inf), dim=0).values
        st2.count[m] = 1
        st2.rank.copy_(_rank_after_create(st, m))
        st2.active[m] = True
        st2.tmpl[m] = slot_t
        st2.n_claims.add_(1)
        # subtractMax on the chosen template's pool limits
        if bool(tb.thas_limits[slot_t]):
            max_cap = torch.max(torch.where(alive_tn[:, None], tb.icap, _i32(0, dev)), dim=0).values
            st2.trem[slot_t] -= torch.where(tb.tlimit_def[slot_t], max_cap, _i32(0, dev))
        slot_global = E + m

    # reservation bookkeeping: the committed claim's held set is recomputed
    # from its final requirements + surviving types
    NRES = st.rescap.shape[0]
    if NRES and kind in (KIND_CLAIM, KIND_NEW):
        slot_r = slot_c if kind == KIND_CLAIM else n_claims
        alive_r = alive_cn if kind == KIND_CLAIM else alive_tn
        alive_o = alive_r[tb.otype.clamp(0, I - 1).long()]
        offb = gather_bits(final_rec.mask, tb.oword, tb.obit)
        off_ok = torch.all(offb | (tb.oword < 0), dim=-1) & tb.ovalid
        cand_o = alive_o & off_ok & (tb.orid >= 0)
        cand_r = torch.zeros(NRES, dtype=torch.int32, device=dev)
        rid = tb.orid.clamp(min=0)
        inb = rid < NRES
        cand_r.index_add_(0, rid.clamp(max=NRES - 1).long(), (cand_o & inb).to(torch.int32))
        NRESW = st.held.shape[1]
        held_old = unpack(st.held[slot_r], NRES)
        new_held = (cand_r > 0) & (held_old | (st.rescap > 0))
        delta = new_held.to(torch.int32) - held_old.to(torch.int32)
        st2.rescap.sub_(delta)
        st2.held[slot_r] = pack(new_held, NRESW)

    # topology record
    pred = kind != KIND_FAIL
    if pred:
        allow_wk = torch.tensor(kind != KIND_EXISTING, device=dev)
        st2_v, st2_h = _record(
            st.v_cnt, st.h_cnt, final_rec, slot_global, allow_wk,
            torch.ones((), dtype=torch.bool, device=dev), x, tb,
        )
        st2.v_cnt.copy_(st2_v)
        st2.h_cnt.copy_(st2_h)
        if HPW:
            hp_add = x.hp_own
            if kind == KIND_NEW:
                hp_add = hp_add | tb.thp[min(max(slot_t, 0), max(T - 1, 0))]
            st2.hp_used[slot_global] |= hp_add

    if kind == KIND_EXISTING:
        out_slot = slot_e
    elif kind == KIND_CLAIM:
        out_slot = slot_c
    elif kind == KIND_NEW:
        out_slot = n_claims
    else:
        out_slot = -1
    return st2, (kind, out_slot, overflow)


def _clone_state(st: State) -> State:
    return State(
        *(
            Reqs(*(a.clone() for a in f)) if isinstance(f, Reqs) else f.clone()
            for f in st
        )
    )


def _x_at_tier(tb: Tables, x: PodX, t: int) -> PodX:
    """The pod's PodX with its tier-t rows where it has tiers (requests,
    selection, inverse and host-port rows do not depend on the tier).
    A single-tier pod keeps its own rows: its rrow is a placeholder and is
    never read."""
    if int(x.ntiers) <= 1:
        return x
    ri = int(x.rrow)
    return x._replace(
        preq=Reqs(*(a[ri, t] for a in tb.rt_preq)),
        typeok=tb.rt_typeok[ri, t],
        tol_t=tb.rt_tol_t[ri, t],
        tol_e=tb.rt_tol_e[ri, t],
        topo_kind=tb.rt_kind[ri, t],
        topo_gid=tb.rt_gid[ri, t],
        topo_sel=tb.rt_sel[ri, t],
    )


def _step_relax(tb: Tables, st: State, x: PodX):
    """scheduler.go:434 trySchedule: a pod tries its relaxation tiers in
    order inside its own step, every tier against the state before the pod,
    until one places it, one overflows the claim slots, or the ladder ends.
    A single-tier pod (and an invalid position) takes exactly one trip.
    Returns (state, (kind, slot, overflow), trips)."""
    trips = 0
    st2, out = st, (KIND_FAIL, -1, False)
    while trips < int(x.ntiers):
        st2, out = _step(tb, st, _x_at_tier(tb, x, trips))
        trips += 1
        kind, _, over = out
        if kind != KIND_FAIL or over or not bool(x.valid):
            break
    return st2, out, trips


def solve_scan_plain(tb: Tables, st: State, xs: PodX, relax: bool = False):
    """The plain version: run the greedy pack over a pod batch, each pod
    through the tier loop when `relax` is set. Returns (state, kinds [P]
    int32, slots [P] int32, overflowed, odometer)."""
    P = xs.valid.shape[0]
    kinds, slots = [], []
    overflow = False
    tier_steps, tier_hist = 0, [0] * ODO_TIER_BINS
    for p in range(P):
        x = PodX(*(Reqs(*(a[p] for a in f)) if isinstance(f, Reqs) else f[p] for f in xs))
        if relax:
            st, (kind, slot, over), trips = _step_relax(tb, st, x)
            tier_steps = tier_tick(tier_steps, tier_hist, trips)
        else:
            st, (kind, slot, over) = _step(tb, st, x)
        kinds.append(kind)
        slots.append(slot)
        overflow = overflow or over
    dev = st.rank.device
    return (
        st,
        torch.tensor(kinds, dtype=torch.int32, device=dev),
        torch.tensor(slots, dtype=torch.int32, device=dev),
        torch.tensor(overflow, device=dev),
        odometer(P, 0, dev, tier_steps, tier_hist),
    )


def solve_scan(tb: Tables, st: State, xs: PodX, relax: bool = False, prof: Optional[torch.Tensor] = None):
    """Run the greedy pack over a pod batch; returns (state, kinds, slots,
    overflowed, odometer). `overflowed` means some pod failed only because
    claim slots ran out (grow N and re-solve); the odometer's `steps` counts
    pod positions walked, pads included, and with `relax` its tier counters
    count the tier-loop trips.

    CPU tensors take the plain version. CUDA tensors launch the
    `scan_step` kernel, which updates a copy of `st` in place; a `prof`
    buffer (`prof_buffer`) gets its per-phase clock breakdown."""
    budgets.seam("solve_scan")
    if st.rank.device.type == "cpu":
        return solve_scan_plain(tb, st, xs, relax)
    return _launch_scan_step(tb, _clone_state(st), xs, relax, prof)


def _lane_field(f, b: int):
    return Reqs(*(a[b] for a in f)) if isinstance(f, Reqs) else f[b]


def lane_slice(t, b: int):
    """Lane b of a State or PodX whose every field has a leading lane axis."""
    return type(t)(*(_lane_field(f, b) for f in t))


def stack_lanes(items: list):
    """States (or PodX batches) stacked on a new leading lane axis (a
    contiguous copy)."""
    return type(items[0])(
        *(
            Reqs(*(torch.stack(list(a)) for a in zip(*fs))) if isinstance(fs[0], Reqs) else torch.stack(list(fs))
            for fs in zip(*items)
        )
    )


def _stack_outs(outs: list):
    """solve_scan tuples of B lanes -> (state [B, ...], kinds [B, P],
    slots [B, P], overflowed [B], odometer with a leading lane axis)."""
    return (
        stack_lanes([o[0] for o in outs]),
        torch.stack([o[1] for o in outs]),
        torch.stack([o[2] for o in outs]),
        torch.stack([o[3] for o in outs]),
        Odometer(*(torch.stack(f) for f in zip(*(o[4] for o in outs)))),
    )


def scan_lanes_plain(tb: Tables, st: State, xs: PodX, valid, relax: bool = False):
    """The plain version of the lane scan: lane b walks the batch `xs`
    over its own state (every field of `st` carries a leading lane axis)
    with its own valid row `valid[b]`, as `solve_scan_plain` does. Returns
    (state [B, ...], kinds [B, P], slots [B, P], overflowed [B], odometer
    [B] per field)."""
    return _stack_outs(
        [solve_scan_plain(tb, lane_slice(st, b), xs._replace(valid=valid[b]), relax) for b in range(valid.shape[0])]
    )


def scan_lanes(tb: Tables, st: State, xs: PodX, valid, relax: bool = False):
    """`solve_scan` over B independent lanes: the reference's
    `vmap(solve_scan)` with the state batched on every field and the pod
    batch shared but for its valid row. Returns scan_lanes_plain's tuple.

    CPU tensors take the plain version. CUDA tensors launch K7
    `scan_lanes` (csrc/scan_lanes.cu: K2's walk with one CTA per lane),
    which updates a copy of `st` in place.

    Replaces: karpenter_tpu/controllers/disruption/sweep.py:690-697
    `jax.vmap(solve_scan)` (the full-state sweep of
    `_prefix_feasibility_traced`).
    Bound on an H100: bytes (each lane reads its state and the shared
    tables once per pod); the lanes run in parallel on the SMs, each a
    dependent chain of K2's block reductions."""
    budgets.seam("scan_lanes")
    if st.rank.device.type == "cpu":
        return scan_lanes_plain(tb, st, xs, valid, relax)
    return _launch_lanes(tb, _clone_state(st), xs._replace(valid=valid), ("valid",), relax, "scan_lanes")


def solve_scan_lanes_plain(tb: Tables, st: State, xs: PodX, relax: bool = False):
    """The plain version of the fleet lanes: `solve_scan_plain` per lane,
    each lane with its own State and PodX (every field of both carries a
    leading lane axis); solve_scan_lanes's tuple."""
    return _stack_outs(
        [solve_scan_plain(tb, lane_slice(st, b), lane_slice(xs, b), relax) for b in range(st.rank.shape[0])]
    )


def solve_scan_lanes(tb: Tables, st: State, xs: PodX, relax: bool = False, prof: Optional[torch.Tensor] = None):
    """One scan-path requeue round for B stacked fleet lanes: the tables
    shared, each lane's own State and pod batch (every field of `st` and
    `xs` with a leading lane axis). Returns (state [B, ...], kinds [B, P],
    slots [B, P], overflowed [B], odometer with a leading lane axis), the
    reference's `fleet_dispatch` tuple.

    CPU tensors take the plain version. CUDA tensors launch K7
    `scan_lanes` with every State and PodX field resolved per lane
    (`lane_pointers`), which updates a copy of `st` in place; a one-lane
    launch takes a `prof` buffer (`prof_buffer("scan_lanes", ...)`) for
    its per-phase clock breakdown, as `solve_scan` does.

    Replaces: karpenter_tpu/solver/fleet.py:164 `fleet_fn`
    (`jit(vmap(solve_scan, in_axes=(None, 0, 0)))`), dispatched by
    `fleet_dispatch` (:215).
    Bound on an H100: bytes (the tables once, and each lane's State read
    and written once, its pod rows read once, its kinds and slots
    written); each lane is K2's dependent chain on its own SM."""
    budgets.seam("solve_scan_lanes")
    if st.rank.device.type == "cpu":
        return solve_scan_lanes_plain(tb, st, xs, relax)
    return _launch_lanes(tb, _clone_state(st), xs, PodX._fields, relax, "fleet_lanes", prof)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers (scan_step and scan_lanes here, run_step in
# tpu_runs.py: all take the argument block of csrc/step_args.h)

# the kernels' shared-memory staging limits (csrc/step_args.h)
_LIMITS = {"TW": 128, "K": 64, "C": 8, "IW": 128, "R": 32, "Gv": 64, "Gh": 64, "HPW": 32, "T": 64, "NRESW": 32}
# the counter block the step kernels write: overflow, steps, bulk_steps,
# next_seq, ptr, tier_steps, then the ODO_TIER_BINS tier_hist bins, then
# the runs walk's stall counter (K3 only)
CNT_STALL = 6 + ODO_TIER_BINS
N_COUNTERS = CNT_STALL + 1


def counter_block(over, steps, bulk_steps, next_seq, ptr, tier_steps, tier_hist, stalled, dev) -> torch.Tensor:
    """A counter block ([N_COUNTERS] int32) from a plain walk's ints."""
    vals = [int(over), steps, bulk_steps, next_seq, ptr, tier_steps, *tier_hist, int(stalled)]
    return torch.tensor(vals, dtype=torch.int32, device=dev)


def counter_fields(block: list) -> tuple:
    """(overflowed, ptr, stalled, odometer dict) of one fetched counter
    block (`block.tolist()`): the runs path reads them in one fetch."""
    odo = {"steps": block[1], "bulk_steps": block[2], "tier_steps": block[5]}
    if odo["tier_steps"]:
        odo["tier_hist"] = list(block[6:CNT_STALL])
    return bool(block[0]), block[4], bool(block[CNT_STALL]), odo


@functools.lru_cache(maxsize=None)
def step_library(name: str):
    """(library, ctypes mirror of StepArgs) for a kernel built on
    csrc/step_args.h. The structure is built from the field names the
    library reports, so the layout is written down once."""
    lib = _build.library(name)
    getattr(lib, f"{name}_field_names").restype = ctypes.c_char_p
    getattr(lib, f"{name}_args_size").restype = ctypes.c_int
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    scratch_bytes = getattr(lib, f"{name}_scratch_bytes")
    scratch_bytes.argtypes = [ctypes.c_void_p]
    scratch_bytes.restype = ctypes.c_longlong
    getattr(lib, f"{name}_phase_names").argtypes = []
    getattr(lib, f"{name}_phase_names").restype = ctypes.c_char_p
    getattr(lib, f"{name}_last_layout").argtypes = [ctypes.c_void_p]
    getattr(lib, f"{name}_last_layout").restype = None
    ptrs, ints = getattr(lib, f"{name}_field_names")().decode().split("|")
    fields = [(n, ctypes.c_void_p) for n in ptrs.split(",") if n]
    fields += [(n, ctypes.c_int) for n in ints.split(",") if n]
    args_type = type("StepArgs", (ctypes.Structure,), {"_fields_": fields})
    if ctypes.sizeof(args_type) != getattr(lib, f"{name}_args_size")():
        raise _build.DeviceError(f"{name}: StepArgs layout disagrees with the library")
    return lib, args_type


def phase_names(name: str) -> list:
    """The phases of a step kernel's clock breakdown (csrc/step_args.h
    KTPU_PHASES), in the order of its prof buffer."""
    lib, _ = step_library(name)
    return [n for n in getattr(lib, f"{name}_phase_names")().decode().split(",") if n]


# the launch tables in the order csrc/step.cuh tab_layout places them
TABLE_ORDER = ("topo", "keys", "offers", "alloc", "bounds", "mask")


def last_layout(name: str) -> dict:
    """Where the library's last launch kept each launch table (True: shared
    memory, False: read from device memory) and its dynamic shared bytes."""
    lib, _ = step_library(name)
    n = len(TABLE_ORDER)
    out = (ctypes.c_longlong * (n + 1))()
    getattr(lib, f"{name}_last_layout")(out)
    return {"shared": {t: out[i] >= 0 for i, t in enumerate(TABLE_ORDER)}, "dynamic_bytes": int(out[n])}


def prof_buffer(name: str, device) -> torch.Tensor:
    """A zeroed prof buffer for one launch of `name`: int64 cycles and
    entries of each phase, then the launch's total cycles and nanoseconds."""
    return torch.zeros(2 * len(phase_names(name)) + 2, dtype=torch.int64, device=device)


def checked_prof(prof: torch.Tensor, name: str, device) -> int:
    want = 2 * len(phase_names(name)) + 2
    if tuple(prof.shape) != (want,):
        raise ValueError(f"{name}: prof buffer has shape {tuple(prof.shape)}, expected ({want},)")
    return checked_ptr(prof, torch.int64, device, "prof")


def breakdown(name: str, prof: torch.Tensor) -> dict:
    """A prof buffer as {"phases": {phase: [cycles, entries]}, "cycles",
    "ns"} (every phase listed, in kernel order)."""
    names = phase_names(name)
    v = prof.cpu().tolist()
    n = len(names)
    return {"phases": {p: [v[i], v[n + i]] for i, p in enumerate(names)}, "cycles": v[2 * n], "ns": v[2 * n + 1]}


class TypeTables(NamedTuple):
    """The instance-type tables the step kernels stage in shared memory once
    per launch (csrc/step.cuh `stage_tables`), derived from Tables on their
    device once per Tables (`launch_type_tables`). The kernels add each
    type's key masks in their prologue (`type_keys`). The type filter reads
    only these (and the alive words of the claim or template it checks)."""

    imask_t: torch.Tensor  # [TW, I] int32: the types' mask words, word-major
    bkeys: torch.Tensor  # [NBK] int32: the keys on which some type has a bound (gt or lt off its sentinel)
    igt_t: torch.Tensor  # [NBK, I] int32: the types' gt on those keys
    ilt_t: torch.Tensor  # [NBK, I] int32: and their lt
    ialloc_t: torch.Tensor  # [R, I] int32: allocatable, resource-major
    oclass: torch.Tensor  # [NOC, 2] int32: each offering class's probes, packed (see type_tables)
    otypes: torch.Tensor  # [NOC, IW] int32: the types offered with that class's probes, as words


def type_tables(tb: Tables) -> TypeTables:
    """The step kernels' type tables of `tb`, none a view of it (a view
    would keep its source alive in `launch_type_tables`' cache). A key no
    type bounds leaves each type's gt/lt at their sentinels, so the kernel
    folds it from the working row alone. An offering counts when it is
    valid, its type is one of the I and every probe is off (word < 0) or a
    bit of the TW words (no other offering can ever match); offerings with
    the same three probes form a class, whose row is [p0 | p1 << 16, p2]
    as int32 bits (probe j = word * 32 + bit, 0xffff when off) beside the
    words of the types offered that way. A type has a matching offering
    exactly when some class whose probes all pass offers it."""
    ir = tb.ireq
    dev = ir.mask.device
    I, TW = ir.mask.shape
    bounded = ((ir.gt != int(GT_NONE)) | (ir.lt != int(LT_NONE))).any(0)
    bk = torch.nonzero(bounded).flatten()
    word, bit = tb.oword.to(torch.int64), tb.obit.to(torch.int64)
    otype = tb.otype.to(torch.int64)
    off = word < 0
    usable = tb.ovalid & (otype >= 0) & (otype < I) & (off | ((word < TW) & (bit >= 0) & (bit < 32))).all(1)
    code = torch.where(off, torch.full_like(word, 0xFFFF), word * 32 + bit)[usable]
    classes, which = torch.unique(code, dim=0, return_inverse=True)
    offered = torch.zeros((classes.shape[0], I), dtype=torch.bool, device=dev)
    offered[which, otype[usable]] = True
    p01 = classes[:, 0] | (classes[:, 1] << 16)
    oclass = torch.stack([torch.where(p01 >= 1 << 31, p01 - (1 << 32), p01), classes[:, 2]], 1).to(torch.int32)
    return TypeTables(
        imask_t=ir.mask.t().clone(memory_format=torch.contiguous_format),
        bkeys=bk.to(torch.int32),
        igt_t=ir.gt[:, bk].t().contiguous(),
        ilt_t=ir.lt[:, bk].t().contiguous(),
        ialloc_t=tb.ialloc.t().clone(memory_format=torch.contiguous_format),
        oclass=oclass.contiguous(),
        otypes=pack(offered, tb.ttypes.shape[1]),
    )


# The sources of type_tables: a Tables' derived tables are cached while
# these very tensors live (Tables are built once per solve and not written).
def _type_sources(tb: Tables) -> tuple:
    ir = tb.ireq
    return (ir.mask, ir.gt, ir.lt, tb.ialloc, tb.oword, tb.obit, tb.otype, tb.ovalid, tb.ttypes)


_TYPE_TABLES: dict = {}


def launch_type_tables(tb: Tables) -> TypeTables:
    """type_tables(tb), derived at the first launch on `tb` and reused by
    every later one; the entry goes when its first source tensor is freed."""
    src = _type_sources(tb)
    key = tuple(map(id, src))
    hit = _TYPE_TABLES.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], src)):
        return hit[1]
    tt = type_tables(tb)
    _TYPE_TABLES[key] = (tuple(weakref.ref(t) for t in src), tt)
    weakref.finalize(src[0], _TYPE_TABLES.pop, key, None)
    return tt


# A cap on the bytes of launch tables the step kernels keep in shared memory
# (StepArgs.SMB; the launch lowers it to what the card leaves). None: no
# cap. chip_smoke.py sets 0 to hold the device-memory path.
SMEM_CAP: Optional[int] = None


def checked_ptr(t: torch.Tensor, dtype: torch.dtype, device: torch.device, name: str) -> int:
    """A kernel argument's device pointer, after checking what the CUDA
    code assumes: the launch's device, the dtype and a contiguous layout."""
    if t.device != device:
        raise ValueError(f"kernel argument {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"kernel argument {name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"kernel argument {name} is not contiguous")
    return t.data_ptr()


# dtypes of a Reqs row's fields, in Reqs._fields order
REQS_DTYPES = (torch.int32, torch.int32, torch.bool, torch.bool, torch.bool, torch.int32, torch.int32, torch.int32)
# dtypes of the PodX fields the step kernels read (preq is a Reqs row;
# rrow and ntiers only with the relax tier loop)
PODX_DTYPES = {
    "prequests": torch.int32, "typeok": torch.int32, "tol_t": torch.bool, "tol_e": torch.bool,
    "topo_kind": torch.int32, "topo_gid": torch.int32, "topo_sel": torch.bool, "sel_v": torch.bool,
    "sel_h": torch.bool, "inv_h": torch.bool, "own_h": torch.bool, "valid": torch.bool,
    "hp_own": torch.int32, "hp_conf": torch.int32, "rrow": torch.int32, "ntiers": torch.int32,
}


def step_arg_values(tb: Tables, st: State, xs: PodX, dev) -> dict:
    """The StepArgs fields both step kernels share: the dims (checked
    against the kernels' limits) and the table, state and pod pointers."""
    N = st.active.shape[0]
    dims = {
        "P": xs.valid.shape[0], "N": N, "E": st.eavail.shape[0], "T": tb.tdaemon.shape[0],
        "I": tb.ialloc.shape[0], "IW": st.alive.shape[1], "TW": tb.va.full_mask.shape[0],
        "K": tb.va.num_keys, "R": tb.ialloc.shape[1], "O": tb.otype.shape[0],
        "Gv": tb.v_reg.shape[0], "VMAX": tb.v_reg.shape[1], "Gh": st.h_cnt.shape[0],
        "GhS": tb.h_skew.shape[0], "S": st.h_cnt.shape[1], "C": xs.topo_kind.shape[1],
        "F": tb.filter_reqs.mask.shape[0], "FA": tb.v_filt.shape[1],
        "HPW": st.hp_used.shape[1], "NRES": st.rescap.shape[0], "NRESW": st.held.shape[1],
    }
    for k, lim in _LIMITS.items():
        if dims[k] > lim:
            raise ValueError(f"step kernel: {k}={dims[k]} exceeds the kernel's limit {lim}")
    if tb.h_filt.shape[1] != dims["FA"] or dims["IW"] * 32 < dims["I"] or dims["S"] != dims["E"] + N:
        raise ValueError(f"step kernel: inconsistent shapes {dims}")
    vals = dict(dims)
    i32, b8 = torch.int32, torch.bool

    def put(name, t, dtype):
        vals[name] = checked_ptr(t, dtype, dev, name)

    def put_reqs(prefix, r: Reqs):
        for field, t, dtype in zip(Reqs._fields, r, REQS_DTYPES):
            put(f"{prefix}_{field}", t, dtype)

    # word2key is int64 in VocabArrays; the kernels read int32 (kept alive
    # by the caller's `vals` through the tensor below)
    w2k = tb.va.word2key.to(torch.int32)
    vals["_keep"] = w2k
    put("word2key", w2k, i32)
    put("well_known", tb.va.well_known, b8)
    put("full_mask", tb.va.full_mask, i32)
    put_reqs("treq", tb.treq)
    for name, dtype in (("tdaemon", i32), ("ttypes", i32), ("tlimit_def", b8), ("thas_limits", b8)):
        put(name, getattr(tb, name), dtype)
    put_reqs("ireq", tb.ireq)
    for name, dtype in (
        ("ialloc", i32), ("icap", i32), ("otype", i32), ("oword", i32), ("obit", i32),
        ("ovalid", b8), ("orid", i32), ("v_kid", i32), ("v_word", i32), ("v_bit", i32),
        ("v_reg", b8), ("v_skew", i32), ("v_mindom", i32), ("v_filt", i32), ("v_anti", b8),
        ("h_skew", i32), ("h_filt", i32), ("h_inverse", b8), ("thp", i32),
    ):
        put(name, getattr(tb, name), dtype)
    put_reqs("freq", tb.filter_reqs)
    tt = launch_type_tables(tb)
    vals["_tt"] = tt
    for name, t in zip(TypeTables._fields, tt):
        put(name, t, i32)
    vals.update(NOC=tt.oclass.shape[0], NBK=tt.bkeys.shape[0], SMB=2**31 - 1 if SMEM_CAP is None else SMEM_CAP)
    for name, dtype in (("active", b8), ("count", i32), ("rank", i32), ("tmpl", i32)):
        put(name, getattr(st, name), dtype)
    put_reqs("creq", st.creq)
    for name, dtype in (("crequests", i32), ("alive", i32), ("cmax_alloc", i32), ("n_claims", i32)):
        put(name, getattr(st, name), dtype)
    put_reqs("ereq", st.ereq)
    for name, dtype in (
        ("eavail", i32), ("trem", i32), ("v_cnt", i32), ("h_cnt", i32),
        ("rescap", i32), ("held", i32), ("hp_used", i32),
    ):
        put(name, getattr(st, name), dtype)
    put_reqs("preq", xs.preq)
    for name, dtype in PODX_DTYPES.items():
        if name not in ("rrow", "ntiers"):
            put(name, getattr(xs, name), dtype)
    return vals


def tier_arg_values(tb: Tables, xs: PodX, vals: dict, dev) -> None:
    """Add the relax tier loop's fields to `vals`: the tier tables, the
    batch's rrow/ntiers, L, NRX and relax=1 (checked against the kernels'
    limits and the batch's shapes)."""
    NRX, L = tb.rt_kind.shape[:2]
    want = {
        "rt_typeok": (NRX, L, vals["IW"]), "rt_tol_t": (NRX, L, vals["T"]), "rt_tol_e": (NRX, L, vals["E"]),
        "rt_kind": (NRX, L, vals["C"]), "rt_gid": (NRX, L, vals["C"]), "rt_sel": (NRX, L, vals["C"]),
    }
    for name, shape in want.items():
        if tuple(getattr(tb, name).shape) != shape:
            raise ValueError(f"step kernel: {name} has shape {tuple(getattr(tb, name).shape)}, expected {shape}")
    if tuple(tb.rt_preq.mask.shape) != (NRX, L, vals["TW"]):
        raise ValueError(f"step kernel: rt_preq has shape {tuple(tb.rt_preq.mask.shape)}")
    if L > MAX_RELAX_TIERS:
        raise ValueError(f"step kernel: L={L} tiers exceed the kernel's limit {MAX_RELAX_TIERS}")
    i32, b8 = torch.int32, torch.bool
    for field, t, dtype in zip(Reqs._fields, tb.rt_preq, REQS_DTYPES):
        vals[f"rt_preq_{field}"] = checked_ptr(t, dtype, dev, f"rt_preq_{field}")
    for name, dtype in (
        ("rt_typeok", i32), ("rt_tol_t", b8), ("rt_tol_e", b8), ("rt_kind", i32), ("rt_gid", i32), ("rt_sel", b8),
    ):
        vals[name] = checked_ptr(getattr(tb, name), dtype, dev, name)
    for name in ("rrow", "ntiers"):
        vals[name] = checked_ptr(getattr(xs, name), i32, dev, name)
    vals.update(L=L, NRX=NRX, relax=1)


def counters_odometer(counters: torch.Tensor, dev) -> Odometer:
    """The Odometer of a step kernel's counter block ([N_COUNTERS], or
    [B, N_COUNTERS] for B lanes: then every field has a leading lane
    axis)."""
    return odometer(counters[..., 1], counters[..., 2], dev, counters[..., 5], counters[..., 6:CNT_STALL])


def step_args(name: str, args_type, vals: dict):
    """The argument block from `vals` (keys starting with "_" only keep
    tensors alive); fields a kernel does not read are 0."""
    given = {k: v for k, v in vals.items() if not k.startswith("_")}
    fields = [f for f, _ in args_type._fields_]
    unknown = set(given) - set(fields)
    if unknown:
        raise _build.DeviceError(f"{name}: argument fields out of step with the library: {sorted(unknown)}")
    return args_type(**{f: given.get(f, 0) for f in fields})


def launch_step(lib, name: str, args_type, vals: dict, dev) -> None:
    """Launch a step kernel on the current stream; raises on a refused
    launch."""
    args = step_args(name, args_type, vals)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = getattr(lib, f"{name}_launch")(ctypes.byref(args), ctypes.c_void_p(stream))
    _build.check_launch(name, code)


def _launch_scan_step(tb: Tables, st: State, xs: PodX, relax: bool, prof: Optional[torch.Tensor] = None):
    """Launch scan_step on `st` (updated in place); returns the
    solve_scan tuple."""
    lib, args_type = step_library("scan_step")
    dev = st.rank.device
    P = xs.valid.shape[0]
    vals = step_arg_values(tb, st, xs, dev)
    if relax:
        tier_arg_values(tb, xs, vals, dev)
    kinds = torch.empty(P, dtype=torch.int32, device=dev)
    slots = torch.empty(P, dtype=torch.int32, device=dev)
    counters = torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev)
    cand = torch.empty(st.active.shape[0], dtype=torch.uint8, device=dev)
    vals["kinds"] = checked_ptr(kinds, torch.int32, dev, "kinds")
    vals["slots"] = checked_ptr(slots, torch.int32, dev, "slots")
    vals["counters"] = checked_ptr(counters, torch.int32, dev, "counters")
    vals["cand"] = checked_ptr(cand, torch.uint8, dev, "cand")
    if prof is not None:
        vals["prof"] = checked_prof(prof, "scan_step", dev)
    # the claim slots' and existing nodes' key masks
    probe = step_args("scan_step", args_type, vals)
    scratch = torch.empty(int(lib.scan_step_scratch_bytes(ctypes.byref(probe))), dtype=torch.uint8, device=dev)
    vals["scratch"] = scratch.data_ptr()
    launch_step(lib, "scan_step", args_type, vals, dev)
    LAUNCHES["scan_step_relax" if relax else "scan_step"] += 1
    budgets.launched("scan_step")
    return st, kinds, slots, counters[0] != 0, counters_odometer(counters, dev)


# the fields K7 resolves per lane, in csrc/step_args.h KTPU_LANE_PTR_FIELDS
# order: the state, the pod batch, the outputs and the scratch block
STATE_PTR_FIELDS = (
    ("active", "count", "rank", "tmpl") + tuple(f"creq_{f}" for f in Reqs._fields)
    + ("crequests", "alive", "cmax_alloc", "n_claims") + tuple(f"ereq_{f}" for f in Reqs._fields)
    + ("eavail", "trem", "v_cnt", "h_cnt", "rescap", "held", "hp_used")
)
PODX_PTR_FIELDS = tuple(f"preq_{f}" for f in Reqs._fields) + tuple(PODX_DTYPES)
LANE_PTR_FIELDS = STATE_PTR_FIELDS + PODX_PTR_FIELDS + ("kinds", "slots", "counters", "cand", "scratch")


@functools.lru_cache(maxsize=None)
def _scan_lanes_library():
    lib, args_type = step_library("scan_lanes")
    lib.scan_lanes_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.scan_lanes_lane_field_names.restype = ctypes.c_char_p
    names = tuple(n for n in lib.scan_lanes_lane_field_names().decode().split(",") if n)
    if names != LANE_PTR_FIELDS:
        raise _build.DeviceError("scan_lanes: the lane fields disagree with the library")
    return lib, args_type


def lane_pointers(lanes: dict, shared: dict, B: int) -> list:
    """K7's lane table, [B * len(LANE_PTR_FIELDS)] addresses in lane-major
    order: for each lane b and each field of LANE_PTR_FIELDS, lane b's row
    of `lanes[name]` (a contiguous tensor with a leading axis of B lanes),
    else the address `shared[name]` that every lane reads (0 when the
    launch does not read the field)."""
    rows = {}
    for name, t in lanes.items():
        if t.shape[0] != B or not t.is_contiguous():
            raise ValueError(f"scan_lanes: {name} is not a contiguous block of {B} lanes")
        # an empty field has no rows: null in every lane, as torch gives it
        rows[name] = (t.data_ptr(), t.stride(0) * t.element_size() if t.numel() else 0)
    out = []
    for b in range(B):
        for name in LANE_PTR_FIELDS:
            if name in rows:
                base, step = rows[name]
                out.append(base + b * step)
            else:
                out.append(shared.get(name, 0))
    return out


def lane_tensors(st: State, xs: PodX, lane_fields, relax: bool, outs: dict, key: str) -> dict:
    """The [B, ...] tensor of every field K7 resolves per lane, by
    LANE_PTR_FIELDS name: each State field, the PodX fields named in
    `lane_fields` (rrow and ntiers only with `relax`) and the outputs and
    scratch in `outs`; each checked for its lane count, dtype, device and
    layout. A PodX field not named is shared by every lane."""
    B = st.rank.shape[0]
    dev = st.rank.device
    lanes = {}

    def put(name, t, dtype):
        if t.shape[0] != B:
            raise ValueError(f"{key}: {name} has {t.shape[0]} lanes, expected {B}")
        checked_ptr(t, dtype, dev, name)
        lanes[name] = t

    i32, b8 = torch.int32, torch.bool
    for name, dtype in (("active", b8), ("count", i32), ("rank", i32), ("tmpl", i32)):
        put(name, getattr(st, name), dtype)
    for prefix in ("creq", "ereq"):
        for field, t, dtype in zip(Reqs._fields, getattr(st, prefix), REQS_DTYPES):
            put(f"{prefix}_{field}", t, dtype)
    for name, dtype in (
        ("crequests", i32), ("alive", i32), ("cmax_alloc", i32), ("n_claims", i32), ("eavail", i32),
        ("trem", i32), ("v_cnt", i32), ("h_cnt", i32), ("rescap", i32), ("held", i32), ("hp_used", i32),
    ):
        put(name, getattr(st, name), dtype)
    for name in lane_fields:
        if name == "preq":
            for field, t, dtype in zip(Reqs._fields, xs.preq, REQS_DTYPES):
                put(f"preq_{field}", t, dtype)
        elif relax or name not in ("rrow", "ntiers"):
            put(name, getattr(xs, name), PODX_DTYPES[name])
    for name, t in outs.items():
        put(name, t, t.dtype)
    return lanes


def _launch_lanes(tb: Tables, st: State, xs: PodX, lane_fields, relax: bool, key: str, prof=None):
    """Launch scan_lanes over st's lanes on `st` (every field with a
    leading lane axis, updated in place); `xs`'s fields named in
    `lane_fields` carry a leading lane axis too, the others are shared by
    every lane. Returns the solve_scan_lanes tuple and counts the launch
    under LAUNCHES[key] (key + "_relax" with the tier loop). The kernel
    reads the shared tables from StepArgs and each lane's state, pod rows,
    outputs and scratch through the lane table (`lane_pointers`)."""
    lib, args_type = _scan_lanes_library()
    dev = st.rank.device
    B = st.rank.shape[0]
    xs0 = PodX(*(_lane_field(f, 0) if name in lane_fields else f for name, f in zip(PodX._fields, xs)))
    P = xs0.valid.shape[0]
    for name, f in zip(PodX._fields, xs0):
        if (f.mask if isinstance(f, Reqs) else f).shape[:1] != (P,):
            raise ValueError(f"{key}: PodX.{name} does not have the batch's {P} positions")
    lane0 = lane_slice(st, 0)
    vals = step_arg_values(tb, lane0, xs0, dev)
    if relax:
        tier_arg_values(tb, xs0, vals, dev)
    if prof is not None:
        if B != 1:
            raise ValueError(f"{key}: the clock breakdown takes a one-lane launch, not {B} lanes")
        vals["prof"] = checked_prof(prof, "scan_lanes", dev)
    N = lane0.active.shape[0]
    # each lane's key masks of its claim slots and existing nodes
    per_lane = int(lib.scan_lanes_scratch_bytes(ctypes.byref(step_args("scan_lanes", args_type, vals))))
    outs = {
        "kinds": torch.empty((B, P), dtype=torch.int32, device=dev),
        "slots": torch.empty((B, P), dtype=torch.int32, device=dev),
        "counters": torch.zeros((B, N_COUNTERS), dtype=torch.int32, device=dev),
        "cand": torch.empty((B, N), dtype=torch.uint8, device=dev),
        "scratch": torch.empty((B, max(per_lane, 16)), dtype=torch.uint8, device=dev),
    }
    table = lane_pointers(lane_tensors(st, xs, lane_fields, relax, outs, key), vals, B)
    args = step_args("scan_lanes", args_type, vals)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.scan_lanes_launch(
        ctypes.byref(args), (ctypes.c_void_p * len(table))(*table), B, ctypes.c_void_p(stream)
    )
    _build.check_launch("scan_lanes", code)
    kinds, slots, counters = outs["kinds"], outs["slots"], outs["counters"]
    LAUNCHES[key + "_relax" if relax else key] += 1
    budgets.launched("scan_lanes", lanes=B)
    return st, kinds, slots, counters[:, 0] != 0, counters_odometer(counters, dev)
