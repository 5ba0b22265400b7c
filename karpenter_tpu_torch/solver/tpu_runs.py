"""The run kernel: bulk-commits whole runs of identical pods per step.

A port of the reference's `solver/tpu_runs.py`. The FFD
order makes pods of one scheduling class contiguous, so the solve order is
a sequence of runs whose per-pod decisions are the same function of the
solver state. `solve_runs` walks the pods with a pointer:

- the first pod of a run (and every pod of a non-bulkable class) takes the
  exact per-pod step (`tpu_kernel._step`, or with `relax` the tier loop
  `tpu_kernel._step_relax`), with the claims' event-sequence key standing in
  for the rank vector; pods with a preference ladder are never bulk;
- a bulkable run builds a small run cache once (per-target viability and
  exact pod-unit capacities), then commits the rest of the run in windows
  of up to W pods: existing nodes first-fill by cumulative capacity,
  in-flight claims take one pod each per count level, a lone feasible claim
  takes a whole window, and fresh claims fill to their pod capacity.

Claims order by the event-sequence key (pod count ascending; creation order
within count 1, promotion recency within count >= 2), the same total order
the exact step's stable rank produces.

Two versions of the same function:

- the plain version, `solve_runs_plain`: a Python loop over the pointer
  with the five bulk cases as functions, mirroring the reference line for
  line. The CPU tests hold it against the JAX package bit for bit.
- the CUDA kernel `run_step` (csrc/run_step.cu), launched by `solve_runs`
  for CUDA tensors: one persistent single-CTA launch walks the pointer on
  the card and shares the exact step with `scan_step` (csrc/step.cuh).

  Replaces: karpenter_tpu/solver/tpu_runs.py:319 `solve_runs` (with
  :185 `_build_cache`, :288 `_record_window`, :161/:172 the final rows,
  :121 `_seq_key`, :136 `_pod_units`), relax on and off.
  Bound on an H100: bytes (the claim rows a window and a cache build read,
  a few MB that stay in L2); in practice the iterations form a dependent
  chain of block reductions, so its time is barrier latency. The design
  keeps the whole walk in one launch and each window's rows in shared
  memory one at a time.

The reference leans on XLA dropping out-of-bounds scatters and clamping
gathers; every such index is masked or clamped here explicitly.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from karpenter_tpu_torch.device import gather_bits, pack, unpack
from karpenter_tpu_torch.ops.encode import Reqs
from karpenter_tpu_torch.ops.kernels import compat, intersect, intersects_only
from karpenter_tpu_torch.solver import tpu_kernel as K
from karpenter_tpu_torch.solver.tpu_kernel import (
    INF_I,
    KIND_CLAIM,
    KIND_EXISTING,
    KIND_FAIL,
    KIND_NEW,
    PodX,
    State,
    Tables,
    _apply_tighten,
    _broadcast_row,
    _eval_topology,
    _i32,
    _row,
    _step,
    _step_relax,
    _topo_nonempty_ok,
    tier_tick,
)
from karpenter_tpu_torch.solver.tpu_problem import TOPO_ANTI_H, TOPO_SPREAD_H

# bulk window: most pods committed per step
W = 64
# seq-key building block; counts and seqs both stay far below it
_SEQ_LIM = 1 << 21
_INT32_MAX = (1 << 31) - 1

# bulk dispatch cases
_CASE_EXISTING = 0
_CASE_LEVEL = 1
_CASE_SOLO = 2
_CASE_NEW = 3
_CASE_FAIL = 4

# launches of the CUDA run kernel (one per solve_runs call on the card)
LAUNCHES = {"run_step": 0, "run_step_relax": 0}


class RunX(NamedTuple):
    """Per-pod driver inputs beyond PodX."""

    x: PodX  # [P] rows
    is_head: torch.Tensor  # [P] bool — first pod of its run
    bulk: torch.Tensor  # [P] bool — class is bulkable (problem gates included)
    # class owns a pod-affinity constraint: its head commits through the
    # exact step before the cache builds
    aff: torch.Tensor  # [P] bool
    run_rem: torch.Tensor  # [P] int32 — pods from i to its run's end, inclusive


class RunCache(NamedTuple):
    """Static-per-run products, built once per run."""

    active: bool  # bulk mode on for the current run
    ok_c: torch.Tensor  # [N] bool — compat + tolerations + topology (pre-capacity)
    excl_c: torch.Tensor  # [N] bool — exact-verify failures (permanent per run)
    ok_e: torch.Tensor  # [E] bool
    cape: torch.Tensor  # [E] int32 — exact pod-units remaining
    ok_t: torch.Tensor  # [T] bool — fully viable
    final_t: Reqs  # [T] — rows a fresh claim writes
    alive_t: torch.Tensor  # [T, IW] words — surviving types of a fresh claim
    capt: torch.Tensor  # [T] int32 — exact pod-units of a fresh claim


def _seq_key(count, seq, active):
    """The claim ordering key. Smaller = earlier. int32 arithmetic wraps
    as the reference's does."""
    within = torch.where(count == 1, seq, _SEQ_LIM - 1 - seq)
    return torch.where(active, count * _SEQ_LIM + within, _i32(_INT32_MAX, count.device))


def _derive_rank(st: State, seq) -> torch.Tensor:
    """Rank vector for a `_step` call: position of each claim under the
    seq-key order (stable, like jnp.argsort)."""
    order = torch.argsort(_seq_key(st.count, seq, st.active), stable=True)
    rank = torch.zeros_like(seq)
    rank[order] = torch.arange(seq.shape[0], dtype=seq.dtype, device=seq.device)
    return rank


def _pod_units(avail, preq):
    """Exact pod-units a resource vector can absorb: min over requested
    dims of floor(avail/req); 0 if any dim is negative."""
    per = torch.where(
        preq > 0,
        torch.div(avail, preq.clamp(min=1), rounding_mode="floor"),
        _i32(INF_I, avail.device),
    )
    units = per.min(dim=-1).values
    return torch.where((avail >= 0).all(dim=-1), units.clamp(min=0), _i32(0, avail.device))


def _rows_at(r: Reqs, idx) -> Reqs:
    return Reqs(*(a[idx] for a in r))


def _set_rows(dst: Reqs, idx, rows: Reqs, pred) -> None:
    """In place: dst[idx[j]] = rows[j] where pred[j] (the reference's
    out-of-bounds drop of the masked-off window tail, made explicit).
    Duplicate targets always carry identical rows."""
    sel = pred.nonzero().flatten()
    for a, r in zip(dst, rows):
        a[idx[sel].long()] = r[sel]


def _cmax(fis, ialloc):
    """[B, R] column max of ialloc over each row's surviving types
    (-INF_I where none survives)."""
    return torch.where(fis[..., None], ialloc[None], _i32(-INF_I, ialloc.device)).max(dim=1).values


# ---------------------------------------------------------------------------
# batched helpers: the reference vmaps its single-row functions over a window


def _type_filter_rows(finals: Reqs, alive_bits, totals, tb: Tables) -> torch.Tensor:
    """[B, I] bool — tpu_kernel._type_filter for each row of `finals`."""
    B = finals.mask.shape[0]
    I = tb.ireq.mask.shape[0]
    a = Reqs(*(x[None] for x in tb.ireq))  # [1, I, ...]
    b = Reqs(*(x[:, None] for x in finals))  # [B, 1, ...]
    t_ok = intersects_only(a, b, tb.va)
    fits = torch.all(totals[:, None, :] <= tb.ialloc[None], dim=-1)
    ow = tb.oword
    off_bit = gather_bits(finals.mask, ow, tb.obit)  # [B, O, 3]
    off_ok = torch.all(off_bit | (ow < 0), dim=-1) & tb.ovalid
    inb = (tb.otype >= 0) & (tb.otype < I)
    off_any = torch.zeros((B, I), dtype=torch.int32, device=ow.device)
    off_any.index_add_(1, tb.otype.clamp(0, max(I - 1, 0)).long(), (off_ok & inb).to(torch.int32))
    return alive_bits & t_ok & fits & (off_any > 0)


def _eval_filters_rows(filt, finals: Reqs, tb: Tables, allow_wk: bool) -> torch.Tensor:
    """[B, G] bool — tpu_kernel._eval_filters for each row of `finals`."""
    B = finals.mask.shape[0]
    G = filt.shape[0]
    dev = filt.device
    if tb.filter_reqs.mask.shape[0] == 0:
        return torch.ones((B, G), dtype=torch.bool, device=dev)
    F = tb.filter_reqs.mask.shape[0]
    ok = torch.zeros((B, G), dtype=torch.bool, device=dev)
    trivial = torch.all(filt < 0, dim=-1)
    fb = Reqs(*(x[:, None] for x in finals))
    for a in range(filt.shape[1]):
        alt = filt[:, a]
        rows = _row(tb.filter_reqs, alt.clamp(0, F - 1).long())
        got = compat(fb, Reqs(*(x[None] for x in rows)), tb.va, allow_wk)
        ok = ok | ((alt >= 0)[None] & got)
    return trivial[None] | ok


# ---------------------------------------------------------------------------
# per-window final-row derivation (topology is static for bulkable runs)


def _final_claim_rows(tb: Tables, st: State, x: PodX, slots):
    """Merged + tightened rows for a window of claim slots."""
    E = st.eavail.shape[0]
    merged = intersect(_rows_at(st.creq, slots), _broadcast_row(x.preq, slots.shape[0]), tb.va)
    te = _eval_topology(merged, st.h_cnt[:, E + slots], torch.any(st.h_cnt > 0, dim=-1), x, st, tb)
    return _apply_tighten(merged, te.tight, te.touched, tb.va)


def _final_existing_rows(tb: Tables, st: State, x: PodX, slots):
    merged = intersect(_rows_at(st.ereq, slots), _broadcast_row(x.preq, slots.shape[0]), tb.va)
    te = _eval_topology(merged, st.h_cnt[:, slots], torch.any(st.h_cnt > 0, dim=-1), x, st, tb)
    return _apply_tighten(merged, te.tight, te.touched, tb.va)


# ---------------------------------------------------------------------------
# cache construction


def _build_cache(tb: Tables, st: State, x: PodX) -> RunCache:
    dev = st.rank.device
    E = st.eavail.shape[0]
    N = st.active.shape[0]
    T = tb.tdaemon.shape[0]
    I = tb.ialloc.shape[0]
    IW = st.alive.shape[1]
    nonempty_h = torch.any(st.h_cnt > 0, dim=-1)

    merged_c = intersect(st.creq, _broadcast_row(x.preq, N), tb.va)
    compat_c = compat(st.creq, _broadcast_row(x.preq, N), tb.va, True)
    te_c = _eval_topology(merged_c, st.h_cnt[:, E:], nonempty_h, x, st, tb)
    final_c = _apply_tighten(merged_c, te_c.tight, te_c.touched, tb.va)
    ok_c = (
        x.tol_t[st.tmpl.clamp(0, max(T - 1, 0)).long()]
        & compat_c
        & te_c.viable
        & _topo_nonempty_ok(final_c, te_c.touched, tb.va)
    )

    if E > 0:
        merged_e = intersect(st.ereq, _broadcast_row(x.preq, E), tb.va)
        compat_e = compat(st.ereq, _broadcast_row(x.preq, E), tb.va, False)
        te_e = _eval_topology(merged_e, st.h_cnt[:, :E], nonempty_h, x, st, tb)
        final_e = _apply_tighten(merged_e, te_e.tight, te_e.touched, tb.va)
        ok_e = x.tol_e & compat_e & te_e.viable & _topo_nonempty_ok(final_e, te_e.touched, tb.va)
        cape = _pod_units(st.eavail, x.prequests[None, :])
    else:
        ok_e = torch.zeros(E, dtype=torch.bool, device=dev)
        cape = torch.zeros(E, dtype=torch.int32, device=dev)

    merged_t = intersect(tb.treq, _broadcast_row(x.preq, T), tb.va)
    compat_t = compat(tb.treq, _broadcast_row(x.preq, T), tb.va, True)
    te_t = _eval_topology(
        merged_t, torch.zeros((st.h_cnt.shape[0], T), dtype=st.h_cnt.dtype, device=dev), nonempty_h, x, st, tb
    )
    final_t = _apply_tighten(merged_t, te_t.tight, te_t.touched, tb.va)
    t_final_i = _type_filter_rows(final_t, unpack(tb.ttypes, I), tb.tdaemon + x.prequests, tb)
    units_t = _pod_units(tb.ialloc[None] - tb.tdaemon[:, None, :], x.prequests[None, None, :])  # [T, I]
    per_type = torch.where(t_final_i, units_t, _i32(0, dev))
    capt = per_type.max(dim=-1).values.clamp(min=0) if I else torch.zeros(T, dtype=torch.int32, device=dev)
    ok_t = compat_t & x.tol_t & te_t.viable & _topo_nonempty_ok(final_t, te_t.touched, tb.va) & t_final_i.any(-1)
    return RunCache(
        active=True,
        ok_c=ok_c,
        excl_c=torch.zeros(N, dtype=torch.bool, device=dev),
        ok_e=ok_e,
        cape=cape,
        ok_t=ok_t,
        final_t=final_t,
        alive_t=pack(t_final_i, IW),
        capt=capt,
    )


def _empty_cache(tb: Tables, st: State) -> RunCache:
    dev = st.rank.device
    E = st.eavail.shape[0]
    N = st.active.shape[0]
    T = tb.tdaemon.shape[0]
    return RunCache(
        active=False,
        ok_c=torch.zeros(N, dtype=torch.bool, device=dev),
        excl_c=torch.zeros(N, dtype=torch.bool, device=dev),
        ok_e=torch.zeros(E, dtype=torch.bool, device=dev),
        cape=torch.zeros(E, dtype=torch.int32, device=dev),
        ok_t=torch.zeros(T, dtype=torch.bool, device=dev),
        final_t=Reqs(*(torch.zeros_like(a) for a in tb.treq)),
        alive_t=torch.zeros((T, st.alive.shape[1]), dtype=torch.int32, device=dev),
        capt=torch.zeros(T, dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# bulk record: the topology Record for a window of commits


def _record_window(st: State, tb: Tables, finals: Reqs, slots, preds, selv, selh, ownh, allow_wk: bool):
    """Batched tpu_kernel._record over a window; returns new (v_cnt,
    h_cnt). `slots` are global (existing e, or E + claim slot)."""
    K_ = tb.va.num_keys
    segbits = gather_bits(finals.mask, tb.v_word, tb.v_bit)  # [W, Gv, VMAX]
    exbits = gather_bits(finals.exmask, tb.v_word, tb.v_bit)
    other_k = finals.other[:, tb.v_kid.clamp(0, K_ - 1).long()]  # [W, Gv]
    single = (segbits.to(torch.int32).sum(-1) == 1) & ~other_k
    filt_ok = _eval_filters_rows(tb.v_filt, finals, tb, allow_wk)
    add = torch.where(
        tb.v_anti[None, :, None],
        torch.where(other_k[..., None], exbits, segbits),
        segbits & single[..., None],
    )
    gate_v = (preds[:, None] & selv & filt_ok)[..., None]
    v_cnt = st.v_cnt + (add & gate_v).to(torch.int32).sum(0)

    filt_ok_h = _eval_filters_rows(tb.h_filt, finals, tb, allow_wk)
    contrib = torch.where(tb.h_inverse[None, :], ownh, selh & filt_ok_h)  # [W, Gh]
    vals = (preds[:, None] & contrib).to(torch.int32)
    h_cnt = st.h_cnt.clone()
    h_cnt.index_add_(1, slots.long(), vals.T.contiguous())
    return v_cnt, h_cnt


# ---------------------------------------------------------------------------
# the plain version


class _Walk:
    """The plain version's loop carry: the state (a private copy, updated
    in place), the run cache, the event sequence and the outputs."""

    def __init__(self, tb: Tables, st: State, rx: RunX, seq, next_seq, relax: bool):
        self.tb, self.rx, self.relax = tb, rx, relax
        self.st = K._clone_state(st)
        self.seq = seq.clone()
        self.nseq = int(next_seq)
        self.dev = st.rank.device
        self.P = rx.is_head.shape[0]
        self.N = st.active.shape[0]
        self.E = st.eavail.shape[0]
        self.I = tb.ialloc.shape[0]
        self.IW = st.alive.shape[1]
        self.kinds = torch.full((self.P + W,), KIND_FAIL, dtype=torch.int32, device=self.dev)
        self.slots = torch.full((self.P + W,), -1, dtype=torch.int32, device=self.dev)
        self.rc = _empty_cache(tb, st)
        self.steps = 0
        self.bulk_steps = 0
        self.tier_steps = 0
        self.tier_hist = [0] * K.ODO_TIER_BINS
        self.jW = torch.arange(W, dtype=torch.int32, device=self.dev)
        # host copies of the driver flags (control flow reads them per pod)
        self.is_head = rx.is_head.tolist()
        self.bulk = rx.bulk.tolist()
        self.aff = rx.aff.tolist()
        self.run_rem = rx.run_rem.tolist()
        self.valid = rx.x.valid.tolist()

    def xrow(self, i: int) -> PodX:
        return PodX(*(Reqs(*(a[i] for a in f)) if isinstance(f, Reqs) else f[i] for f in self.rx.x))

    def write_window(self, ptr: int, wk, ws) -> None:
        self.kinds[ptr : ptr + W] = wk
        self.slots[ptr : ptr + W] = ws

    # -- exact per-pod path (run heads; all pods of non-bulk classes) --

    def single_step(self, ptr: int) -> tuple[int, bool]:
        st, x = self.st, self.xrow(ptr)
        # the seq key is a monotone transform of the rank order and _step
        # only uses rank for min-selection, so the key substitutes directly
        st_in = st._replace(rank=_seq_key(st.count, self.seq, st.active))
        n_claims = int(st.n_claims)
        if self.relax:
            # every tier reuses the seq key written once above
            st2, (kind, slot, oflow), trips = _step_relax(self.tb, st_in, x)
            self.tier_steps = tier_tick(self.tier_steps, self.tier_hist, trips)
        else:
            st2, (kind, slot, oflow) = _step(self.tb, st_in, x)
        upd = kind in (KIND_CLAIM, KIND_NEW)
        sslot = slot if kind == KIND_CLAIM else n_claims
        if upd and sslot < self.N:
            self.seq[sslot] = self.nseq
        self.nseq += int(upd)
        self.kinds[ptr] = kind
        self.slots[ptr] = slot
        self.steps += 1
        self.st = st2
        if self.bulk[ptr] and self.run_rem[ptr] > 1 and self.valid[ptr] and not oflow:
            self.rc = _build_cache(self.tb, st2, x)
        else:
            self.rc = self.rc._replace(active=False)
        # an overflowing pod is not decided: ptr stays on it for the host's
        # continuation against the grown state
        return (0 if oflow else 1), bool(oflow)

    # -- bulk phases --

    def h_budgets(self, x: PodX, offs: int, n: int):
        """Hostname budgets: spread-h / anti-h constraints that select the
        pod consume one unit per commit (skew - count, 1 - count)."""
        tb, st = self.tb, self.st
        Gh = st.h_cnt.shape[0]
        inf = _i32(INF_I, self.dev)
        bud = inf.expand(n)
        fresh = inf
        for c in range(x.topo_kind.shape[0]):
            kind = x.topo_kind[c]
            gid = x.topo_gid[c].clamp(0, Gh - 1).long()
            dyn = x.topo_sel[c] & ((kind == TOPO_SPREAD_H) | (kind == TOPO_ANTI_H))
            cap0 = torch.where(kind == TOPO_SPREAD_H, tb.h_skew[gid], _i32(1, self.dev))
            cnt = st.h_cnt[gid, offs : offs + n]
            bud = torch.minimum(bud, torch.where(dyn, cap0 - cnt, inf))
            fresh = torch.minimum(fresh, torch.where(dyn, cap0, inf))
        return bud, fresh

    def bulk_step(self, ptr: int) -> tuple[int, bool]:
        tb, st, rc = self.tb, self.st, self.rc
        E, N, I, dev, jW = self.E, self.N, self.I, self.dev, self.jW
        self.steps += 1
        self.bulk_steps += 1
        x = self.xrow(ptr)
        rem = self.run_rem[ptr]
        widx = (ptr + jW).clamp(0, self.P - 1).long()
        selv, selh, ownh = self.rx.x.sel_v[widx], self.rx.x.sel_h[widx], self.rx.x.own_h[widx]

        hb_c, hb_fresh = self.h_budgets(x, E, N)
        screen_fits = torch.all(st.crequests + x.prequests <= st.cmax_alloc, dim=-1)
        screen_types = torch.any((st.alive & x.typeok) != 0, dim=-1)
        feas_c = st.active & rc.ok_c & ~rc.excl_c & screen_fits & screen_types & (hb_c > 0)
        nfeas = int(feas_c.sum())
        viable_t = rc.ok_t & (rc.capt > 0)
        anyt = bool(viable_t.any())
        t_first = int(viable_t.to(torch.int32).argmax()) if anyt else 0
        any_e = False
        if E > 0:
            hb_e, _ = self.h_budgets(x, 0, E)
            feas_e = rc.ok_e & (rc.cape > 0) & (hb_e > 0)
            any_e = bool(feas_e.any())
        if any_e:
            case = _CASE_EXISTING
        elif nfeas > 1:
            case = _CASE_LEVEL
        elif nfeas == 1:
            case = _CASE_SOLO
        elif anyt:
            case = _CASE_NEW
        else:
            case = _CASE_FAIL

        fail_w = torch.full((W,), KIND_FAIL, dtype=torch.int32, device=dev)
        none_w = torch.full((W,), -1, dtype=torch.int32, device=dev)
        oflow = False
        if case == _CASE_EXISTING:
            k, wk, ws = self.case_existing(x, rem, feas_e, hb_e, selv, selh, ownh)
        elif case == _CASE_LEVEL:
            k, wk, ws = self.case_level(x, rem, feas_c, selv, selh, ownh)
        elif case == _CASE_SOLO:
            k, wk, ws = self.case_solo(x, rem, feas_c, hb_c, selv, selh, ownh)
        elif case == _CASE_NEW:
            k, wk, ws, oflow = self.case_new(x, rem, t_first, hb_fresh, selv, selh, ownh)
        else:
            k, wk, ws = min(rem, W), fail_w, none_w
        self.write_window(ptr, wk, ws)
        return k, oflow

    def case_existing(self, x, rem, feas_e, hb_e, selv, selh, ownh):
        st, rc, jW, E = self.st, self.rc, self.jW, self.E
        caps = torch.where(feas_e, torch.minimum(rc.cape, hb_e), _i32(0, self.dev))
        cum = torch.cumsum(caps, 0, dtype=torch.int32) - caps
        k = min(rem, int(caps.sum()), W)
        inr = (jW[:, None] >= cum[None, :]) & (jW[:, None] < (cum + caps)[None, :])
        tgt = torch.argmax(inr.to(torch.int32), dim=1).to(torch.int32)
        pred = jW < k
        finals = _final_existing_rows(self.tb, st, x, tgt.long())
        added = torch.zeros(E, dtype=torch.int32, device=self.dev)
        added.index_add_(0, tgt.long(), pred.to(torch.int32))
        v_cnt, h_cnt = _record_window(st, self.tb, finals, tgt, pred, selv, selh, ownh, allow_wk=False)
        st.eavail.sub_(added[:, None] * x.prequests[None, :])
        _set_rows(st.ereq, tgt, finals, pred)
        self.st = st._replace(v_cnt=v_cnt, h_cnt=h_cnt)
        self.rc = rc._replace(cape=rc.cape - added)
        wk = torch.where(pred, _i32(KIND_EXISTING, self.dev), _i32(KIND_FAIL, self.dev))
        return k, wk, torch.where(pred, tgt, _i32(-1, self.dev))

    def case_level(self, x, rem, feas_c, selv, selh, ownh):
        """One pod per feasible claim at the minimum count, in block order
        (the W smallest keys, ties to the lower index like lax.top_k)."""
        st, rc, jW, N, dev = self.st, self.rc, self.jW, self.N, self.dev
        inf = _i32(INF_I, dev)
        cmin = int(torch.where(feas_c, st.count, inf).min())
        lvl = feas_c & (st.count == cmin)
        ordkey = torch.where(lvl, self.seq if cmin == 1 else _SEQ_LIM - 1 - self.seq, inf)
        order_w = torch.sort(ordkey, stable=True).indices[: min(W, N)].to(torch.int32)
        k = min(rem, int(lvl.sum()), W)
        tgt = torch.zeros(W, dtype=torch.int32, device=dev)
        tgt[: min(W, N)] = order_w
        pred = jW < k
        finals = _final_claim_rows(self.tb, st, x, tgt.long())
        totals = st.crequests[tgt.long()] + x.prequests[None, :]
        # surviving-type bits for the grown request: the exact verify and
        # the post-commit alive/cmax refresh at once
        fis = _type_filter_rows(finals, unpack(st.alive[tgt.long()], self.I), totals, self.tb)
        okv = fis.any(-1) | ~pred
        newexcl = torch.zeros(N, dtype=torch.bool, device=dev)
        newexcl[tgt[pred & ~okv].long()] = True
        pred = pred & okv
        kc = int(pred.sum())
        # compact verified targets to the window front, in window order
        vorder = torch.sort(torch.where(pred, jW, inf), stable=True).indices
        tgt = tgt[vorder]
        finals = _rows_at(finals, vorder)
        fis = fis[vorder]
        pred = jW < kc
        self.rc = rc._replace(excl_c=rc.excl_c | newexcl)
        return self.commit_claims(x, tgt, pred, kc, finals, fis, selv, selh, ownh)

    def case_solo(self, x, rem, feas_c, hb_c, selv, selh, ownh):
        st, dev = self.st, self.dev
        s = int(feas_c.to(torch.int32).argmax())
        final_n = _final_claim_rows(self.tb, st, x, torch.tensor([s], device=dev))
        alive_n = unpack(st.alive[s], self.I)
        per = torch.where(
            alive_n, _pod_units(self.tb.ialloc - st.crequests[s][None, :], x.prequests[None, :]), _i32(0, dev)
        )
        tok = _type_filter_rows(final_n, alive_n[None], (st.crequests[s] + x.prequests)[None], self.tb)[0]
        per = torch.where(tok, per, _i32(0, dev))
        cap = min(max(int(per.max()) if self.I else 0, 0), int(hb_c[s]))
        k = min(rem, cap, W)
        if k <= 0:
            excl = self.rc.excl_c.clone()
            excl[s] = True
            self.rc = self.rc._replace(excl_c=excl)
            fail = torch.full((W,), KIND_FAIL, dtype=torch.int32, device=dev)
            return 0, fail, torch.full((W,), -1, dtype=torch.int32, device=dev)
        # types surviving the k-pod load on this claim
        fi_k = _type_filter_rows(final_n, alive_n[None], (st.crequests[s] + k * x.prequests)[None], self.tb)
        tgt = torch.full((W,), s, dtype=torch.int32, device=dev)
        finals = Reqs(*(a.expand((W,) + a.shape[1:]) for a in final_n))
        return self.commit_claims(
            x, tgt, self.jW < k, k, finals, fi_k.expand(W, -1), selv, selh, ownh, solo_units=k
        )

    def commit_claims(self, x, tgt, pred, kc, finals, fis, selv, selh, ownh, solo_units=None):
        """tgt[j] gets pod ptr+j for j < kc; targets are distinct unless
        solo_units is set (then every window row shares tgt[0])."""
        st, dev, N, E = self.st, self.dev, self.N, self.E
        sel = pred.nonzero().flatten()
        t = tgt[sel].long()
        if solo_units is None:
            st.crequests[t] += x.prequests[None, :]
            st.count[t] += 1
            self.seq[t] = torch.maximum(self.seq[t], self.nseq + self.jW[sel])
            self.nseq += kc
        else:
            s = int(tgt[0])
            st.crequests[s] += solo_units * x.prequests
            st.count[s] += solo_units
            self.seq[s] = self.nseq + solo_units - 1
            self.nseq += solo_units
        v_cnt, h_cnt = _record_window(st, self.tb, finals, E + tgt, pred, selv, selh, ownh, allow_wk=True)
        _set_rows(st.creq, tgt, finals, pred)
        st.alive[t] = pack(fis, self.IW)[sel]
        st.cmax_alloc[t] = _cmax(fis, self.tb.ialloc)[sel]
        self.st = st._replace(v_cnt=v_cnt, h_cnt=h_cnt)
        wk = torch.where(pred, _i32(KIND_CLAIM, dev), _i32(KIND_FAIL, dev))
        return kc, wk, torch.where(pred, tgt, _i32(-1, dev))

    def case_new(self, x, rem, t, hb_fresh, selv, selh, ownh):
        """Fresh claims from template t: each absorbs cstar pods, then the
        next pod starts the next claim, so one step creates a batch of
        claims on the contiguous slots m..m+ncl-1."""
        st, rc, tb, jW, dev, N, E = self.st, self.rc, self.tb, self.jW, self.dev, self.N, self.E
        m = int(st.n_claims)
        if m >= N:
            fail = torch.full((W,), KIND_FAIL, dtype=torch.int32, device=dev)
            return 0, fail, torch.full((W,), -1, dtype=torch.int32, device=dev), True
        # cstar > 0: capt[t] > 0 by viable_t, and hostname budgets start >= 1
        cstar = max(min(int(rc.capt[t]), int(hb_fresh)), 1)
        ncl = min((rem + cstar - 1) // cstar, N - m, max(W // cstar, 1))
        f = min(rem, ncl * cstar, W)
        ncl = (f + cstar - 1) // cstar
        pred = jW < f
        cl_of = torch.clamp(jW // cstar, max=N - 1)
        fills = torch.clamp(f - jW[:ncl] * cstar, 0, cstar)  # [ncl]
        alive_m = unpack(rc.alive_t[t], self.I)
        per = torch.where(
            alive_m, _pod_units(tb.ialloc - tb.tdaemon[t][None, :], x.prequests[None, :]), _i32(0, dev)
        )
        # two fill levels only: cstar for full claims, a remainder on the last
        fi_lv = torch.stack([alive_m & (per >= cstar), alive_m & (per >= f - (ncl - 1) * cstar)])
        pack_lv = pack(fi_lv, self.IW)
        cmax_lv = _cmax(fi_lv, tb.ialloc)
        lv = (fills != cstar).long()  # 0 full, 1 last
        final_n = _row(rc.final_t, t)
        idx = torch.arange(m, m + ncl, device=dev)
        st.crequests[idx] = tb.tdaemon[t][None, :] + fills[:, None] * x.prequests[None, :]
        st.alive[idx] = pack_lv[lv]
        st.cmax_alloc[idx] = cmax_lv[lv]
        for a, r in zip(st.creq, final_n):
            a[idx] = r
        st.count[idx] = fills
        st.active[idx] = True
        st.tmpl[idx] = t
        # claim q's last fill event: cumulative pods through it
        self.seq[idx] = self.nseq + torch.cumsum(fills, 0, dtype=torch.int32) - 1
        self.nseq += f
        finals = Reqs(*(a.expand((W,) + a.shape) for a in final_n))
        v_cnt, h_cnt = _record_window(
            st, tb, finals, E + torch.clamp(m + cl_of, max=N - 1), pred, selv, selh, ownh, allow_wk=True
        )
        st.n_claims.fill_(m + ncl)
        self.st = st._replace(v_cnt=v_cnt, h_cnt=h_cnt)
        wk = torch.where(pred, _i32(KIND_NEW, dev), _i32(KIND_FAIL, dev))
        return f, wk, torch.where(pred, m + cl_of, _i32(-1, dev)), False


def solve_runs_plain(tb: Tables, st: State, rx: RunX, seq, next_seq, n_valid: int, relax: bool = False):
    """The plain version. Returns (state, seq, next_seq, kinds[P],
    slots[P], overflowed, odometer, ptr); pods at index >= n_valid are
    shape padding and are never visited. An overflow stops the walk with
    ptr on the overflowing pod: everything before it is decided and does
    not depend on the slot count, so the host grows the state and goes on
    from ptr (a tiered pod then starts again at tier 0). With `relax` the
    exact step is the tier loop."""
    w = _Walk(tb, st, rx, seq, next_seq, relax)
    ptr, over = 0, False
    while ptr < n_valid and not over:
        # non-affinity bulk heads build the cache up front and commit their
        # own pod through the bulk machinery
        head_build = w.is_head[ptr] and w.bulk[ptr] and not w.aff[ptr] and w.valid[ptr]
        if head_build:
            w.rc = _build_cache(tb, w.st, w.xrow(ptr))
        if w.rc.active and w.bulk[ptr] and (head_build or not w.is_head[ptr]):
            k, oflow = w.bulk_step(ptr)
        else:
            k, oflow = w.single_step(ptr)
        ptr += k
        over = over or oflow
    dev = w.dev
    return (
        w.st,
        w.seq,
        _i32(w.nseq, dev),
        w.kinds[: w.P],
        w.slots[: w.P],
        torch.tensor(over, device=dev),
        K.odometer(w.steps, w.bulk_steps, dev, w.tier_steps, w.tier_hist),
        _i32(ptr, dev),
    )


def solve_runs(
    tb: Tables, st: State, rx: RunX, seq, next_seq, n_valid: int, relax: bool = False, prof: Optional[torch.Tensor] = None
):
    """solve_runs_plain's contract. CPU tensors take the plain version;
    CUDA tensors launch the `run_step` kernel on copies of `st` and
    `seq`; a `prof` buffer (`tpu_kernel.prof_buffer`) gets its per-phase
    clock breakdown."""
    if st.rank.device.type == "cpu":
        return solve_runs_plain(tb, st, rx, seq, next_seq, n_valid, relax)
    return _launch_run_step(tb, K._clone_state(st), rx, seq.clone(), next_seq, n_valid, relax, prof)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper


def _launch_run_step(tb: Tables, st: State, rx: RunX, seq, next_seq, n_valid: int, relax: bool, prof=None):
    lib, args_type = K.step_library("run_step")
    dev = st.rank.device
    P = rx.is_head.shape[0]
    if not 0 <= n_valid <= P:
        raise ValueError(f"run_step: n_valid={n_valid} outside [0, {P}]")
    vals = K.step_arg_values(tb, st, rx.x, dev)
    if relax:
        K.tier_arg_values(tb, rx.x, vals, dev)
    kinds = torch.full((P,), KIND_FAIL, dtype=torch.int32, device=dev)
    slots = torch.full((P,), -1, dtype=torch.int32, device=dev)
    counters = torch.zeros(K.N_COUNTERS, dtype=torch.int32, device=dev)
    counters[3] = int(next_seq)
    cand = torch.empty(st.active.shape[0], dtype=torch.uint8, device=dev)
    vals.update(n_valid=n_valid, P=P)
    for name, t, dtype in (
        ("kinds", kinds, torch.int32), ("slots", slots, torch.int32), ("cand", cand, torch.uint8),
        ("seq", seq, torch.int32), ("counters", counters, torch.int32),
        ("is_head", rx.is_head, torch.bool), ("bulk", rx.bulk, torch.bool), ("aff", rx.aff, torch.bool),
        ("run_rem", rx.run_rem, torch.int32),
    ):
        vals[name] = K.checked_ptr(t, dtype, dev, name)
    # the kernel's run cache and window rows live in one scratch block
    probe = K.step_args("run_step", args_type, vals)
    scratch = torch.empty(int(lib.run_step_scratch_bytes(ctypes.byref(probe))), dtype=torch.uint8, device=dev)
    vals["scratch"] = scratch.data_ptr()
    if prof is not None:
        vals["prof"] = K.checked_prof(prof, "run_step", dev)
    K.launch_step(lib, "run_step", args_type, vals, dev)
    LAUNCHES["run_step_relax" if relax else "run_step"] += 1
    return st, seq, counters[3], kinds, slots, counters[0] != 0, K.counters_odometer(counters, dev), counters[4]
