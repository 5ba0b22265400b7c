// K3 run_step: the run kernel's pointer walk over a pod batch in one
// launch, with the exact per-pod step of step.cuh for run heads and pods of
// non-bulk classes, and bulk windows for the rest of a bulkable run.
//
// Replaces karpenter_tpu/solver/tpu_runs.py:319 `solve_runs` (with :185
// `_build_cache`, :288 `_record_window`, :161/:172 the final rows, :121
// `_seq_key` and :136 `_pod_units`), relax on and off.
//
// Design. One CTA of NT threads walks `ptr` from 0 to n_valid, never
// returning to the host, and stops at a claim-slot overflow with `ptr` on
// the overflowing pod. Each iteration stages the pod and then:
//   - on a non-affinity bulk head, builds the run cache (run_cache.cuh:
//     claims and existing nodes: threads over rows; templates: one at a
//     time, the type filter threads over I) into global scratch;
//   - on a bulk iteration, chooses the window's case by block reductions
//     over the claims and existing nodes, and runs it;
//   - otherwise writes the claims' seq key into `rank`, takes the exact
//     step (with relax, the tier loop relax_step, every tier reusing that
//     key), and (for a bulkable run with pods left) builds the cache.
//     Tiered classes are never bulk, so no window and no cache build sees
//     a tier's rows; a cache build restages the pod's own rows.
// Counters (overflow, steps, bulk_steps, next_seq, ptr, tier_steps,
// tier_hist) go to `counters`.
//
// A bulk window's rows run across warps. Every row of a window is taken
// against the state before the window, so the rows are independent: the
// level case picks its k targets in one selection pass (ranks over the
// level's (key, index) pairs, like lax.top_k), then warp w builds targets
// w, w + 16, ... each in its own working row (`WorkRow` 1 + w): the final
// row, the exact type filter of the grown request and the allocatable max
// of the survivors, kept in the window scratch. The existing-node case
// builds its distinct targets' rows the same way. The commits follow, one
// warp per target (each target is a distinct slot), and then the topology
// records in window order, each thread owning its groups, so the counts
// come out as the sequential records leave them.
//
// Bound on an H100: bytes (a cache build reads every claim row, a window
// its targets' rows: a few MB that stay in L2); in practice the walk is a
// dependent chain of barriers and the loads between them, so its time is
// their latency: PERF.md §5 has the per-phase clock breakdown before and
// after this design.
#include "step.cuh"
#include "run_cache.cuh"

#define SEQ_LIM (1 << 21)

enum { CASE_EXISTING = 0, CASE_LEVEL = 1, CASE_SOLO = 2, CASE_NEW = 3, CASE_FAIL = 4 };

// the claim ordering key (tpu_runs.py _seq_key), int32 wrapping
__device__ __forceinline__ int seq_key(int count, int seq, bool active) {
  if (!active) return INT_MAX;
  const int within = count == 1 ? seq : SEQ_LIM - 1 - seq;
  return (int)((unsigned)count * (unsigned)SEQ_LIM + (unsigned)within);
}

// hostname budget of global slot `col`: spread-h / anti-h constraints that
// select the pod consume one unit per commit
__device__ int h_budget(int col) {
  int bud = INF_I;
  for (int c = 0; c < A.C; ++c)
    if (sh.hdyn[c]) bud = min(bud, sh.hcap0[c] - hcnt(sh.hgid[c], col));
  return bud;
}

__device__ __forceinline__ const uint8_t* sel_row(const void* base, int j, int G) {
  return (const uint8_t*)base + (long long)clampi(j, 0, A.P - 1) * G;
}

// the topology record of final row `f` for the pod at position j
__device__ void record_window_row(int j, const FinalRow& f, int slot_global, bool allow_wk) {
  record_row(f, slot_global, allow_wk, sel_row(A.sel_v, j, A.Gv), sel_row(A.sel_h, j, A.Gh), sel_row(A.own_h, j, A.Gh));
}

// Target j's final row for its records: while a window has at most one
// target a warp, it is still in warp j's working row; else the scratch copy.
__device__ __forceinline__ FinalRow window_row(const Scratch& S, int j, int k) {
  return k <= NWARP ? final_of(wrow(1 + j)) : final_of(row_of(S.wfin, j), keys_at(S.wkeys, j));
}

// ---------------------------------------------------------------------------
// bulk cases; each returns the pods it decided (the window's k)

// existing nodes first-fill by cumulative capacity, in node order
__device__ __noinline__ int case_existing(int p, int rem, const Scratch& S) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, E = A.E, R = A.R;
  if (warp == 0) {
    unsigned total = 0;  // int32 wrapping sum, as the reference's
    for (int e = lane; e < E; e += 32) total += (unsigned)S.caps[e];
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(FULL_MASK, total, off);
    const int k = max(min(rem, min((int)total, KTPU_RUN_W)), 0);
    // node e takes the window positions [before, before + caps[e]) below k,
    // `before` its predecessors' capacity (each cut to the window: k <= W)
    int carry = 0;
    for (int e0 = 0; e0 < E && carry < k; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < E ? min(S.caps[e], KTPU_RUN_W) : 0;
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += y;
      }
      const int start = carry + incl - c, stop = min(start + c, k);
      for (int j = start; j < stop; ++j) sh.wtgt[j] = e;
      carry += __shfl_sync(FULL_MASK, incl, 31);
    }
    if (lane == 0) sh.r_k = k;
  }
  __syncthreads();
  const int k = sh.r_k;
  // the final row of each distinct target, one warp each, against the state
  // before the window
  WorkRow& W = wrow(1 + warp);
  for (int j = warp; j < k; j += NWARP) {
    const int e = sh.wtgt[j];
    if (j > 0 && sh.wtgt[j - 1] == e) continue;
    build_row<true>(W, ROW(ereq, e), keys_at(S.kc.e, e), e, false);
    write_row<true>(row_of(S.wfin, j), W);
    if (lane == 0) keys_put(S.wkeys, j, W.fk, W.fbnd);
    __syncwarp();
  }
  __syncthreads();
  prof_mark(PH_existing_rows);
  // commits, one warp per distinct target
  for (int j = warp; j < k; j += NWARP) {
    const int e = sh.wtgt[j];
    if (j > 0 && sh.wtgt[j - 1] == e) continue;
    int j1 = j;
    while (j1 < k && sh.wtgt[j1] == e) ++j1;
    const int added = j1 - j;
    for (int r = lane; r < R; r += 32) I32(eavail)[(long long)e * R + r] -= added * sh.preq[r];
    copy_row<true>(ROW(ereq, e), row_of(S.wfin, j));
    if (lane == 0) {
      keys_put(S.kc.e, e, keys_at(S.wkeys, j), bnd_at(S.wkeys, j));
      S.cape[e] -= added;
    }
  }
  // topology records in window order
  for (int j = 0; j < k;) {
    const int e = sh.wtgt[j];
    int j1 = j;
    while (j1 < k && sh.wtgt[j1] == e) ++j1;
    const FinalRow f = window_row(S, j, k);
    for (int q = j; q < j1; ++q) record_window_row(p + q, f, e, false);
    j = j1;
  }
  for (int j = tid; j < k; j += NT) {
    I32(kinds)[p + j] = KIND_EXISTING;
    I32(slots)[p + j] = sh.wtgt[j];
  }
  __syncthreads();
  prof_mark(PH_existing_commit);
  return k;
}

// The k smallest (key, index) of the level's nl claims into sh.wtgt[0..k),
// like lax.top_k: the level goes into a list over the warps' working rows
// and each member counts the members before it; a level too long for the
// list takes k block argmins instead.
__device__ void select_level(int k, int cm, int nl) {
  const int tid = threadIdx.x, N = A.N;
  const int cap = NWARP * (int)sizeof(WorkRow) / 8;
  if (nl <= cap) {
    int* lkey = (int*)&wrow(1);
    int* lidx = lkey + cap;
    if (tid == 0) sh.lcount = 0;
    __syncthreads();
    for (int n = tid; n < N; n += NT)
      if (U8(cand)[n] && I32(count)[n] == cm) {
        const int at = atomicAdd(&sh.lcount, 1);
        lkey[at] = cm == 1 ? I32(seq)[n] : SEQ_LIM - 1 - I32(seq)[n];
        lidx[at] = n;
      }
    __syncthreads();
    const int L = sh.lcount;
    for (int q = tid; q < L; q += NT) {
      const int key = lkey[q], idx = lidx[q];
      int rank = 0;
      for (int s = 0; s < L && rank < k; ++s) {
        const int ks = lkey[s];
        rank += ks < key || (ks == key && lidx[s] < idx);
      }
      if (rank < k) {
        sh.wtgt[rank] = idx;
        U8(cand)[idx] = 0;
      }
    }
    __syncthreads();
    return;
  }
  for (int j = 0; j < k; ++j) {
    int bk = INT_MAX, bi = INT_MAX;
    for (int n = tid; n < N; n += NT)
      if (U8(cand)[n] && I32(count)[n] == cm) {
        const int key = cm == 1 ? I32(seq)[n] : SEQ_LIM - 1 - I32(seq)[n];
        if (key < bk || (key == bk && n < bi)) {
          bk = key;
          bi = n;
        }
      }
    block_argmin(bk, bi);
    if (tid == 0) {
      sh.wtgt[j] = sh.best_idx;
      U8(cand)[sh.best_idx] = 0;
    }
    __syncthreads();
  }
}

// one pod per feasible claim at the minimum count, in block order
__device__ __noinline__ int case_level(int p, int rem, const Scratch& S) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, E = A.E, N = A.N, R = A.R, IW = A.IW;
  int cm = INF_I;
  for (int n = tid; n < N; n += NT)
    if (U8(cand)[n]) cm = min(cm, I32(count)[n]);
  cm = block_reduce(cm, RED_MIN);
  int nl = 0;
  for (int n = tid; n < N; n += NT) nl += U8(cand)[n] && I32(count)[n] == cm;
  nl = block_reduce(nl, RED_SUM);
  const int k = min(rem, min(nl, KTPU_RUN_W));
  select_level(k, cm, nl);
  prof_mark(PH_level_select);
  // final rows, the exact type verify of the grown request and the
  // survivors' allocatable max, one warp per target
  WorkRow& W = wrow(1 + warp);
  for (int j = warp; j < k; j += NWARP) {
    const int n = sh.wtgt[j];
    build_row<true>(W, ROW(creq, n), keys_at(S.kc.c, n), E + n, true);
    for (int r = lane; r < R; r += 32) W.total[r] = I32(crequests)[(long long)n * R + r] + sh.preq[r];
    __syncwarp();
    const bool ok = type_filter<true>(W, 0, n);
    surviving_max_alloc<true>(W);
    write_row<true>(row_of(S.wfin, j), W);
    for (int w = lane; w < IW; w += 32) S.wfi[j * IW + w] = (int)W.fi[w];
    for (int r = lane; r < R; r += 32) S.wcmax[j * R + r] = W.red[r];
    if (lane == 0) {
      keys_put(S.wkeys, j, W.fk, W.fbnd);
      sh.wok[j] = ok;
    }
    __syncwarp();
  }
  __syncthreads();
  prof_mark(PH_level_rows);
  // verified targets go to the window front in window order; failures are
  // excluded for the rest of the run
  if (warp == 0) {
    const bool ok0 = lane < k && sh.wok[lane], ok1 = lane + 32 < k && sh.wok[lane + 32];
    const unsigned b0 = __ballot_sync(FULL_MASK, ok0), b1 = __ballot_sync(FULL_MASK, ok1);
    const unsigned below = (1u << lane) - 1u;
    if (ok0) sh.worder[__popc(b0 & below)] = lane;
    if (ok1) sh.worder[__popc(b0) + __popc(b1 & below)] = lane + 32;
    if (lane < k && !ok0) S.excl_c[sh.wtgt[lane]] = 1;
    if (lane + 32 < k && !ok1) S.excl_c[sh.wtgt[lane + 32]] = 1;
    if (lane == 0) sh.r_k = __popc(b0) + __popc(b1);
  }
  __syncthreads();
  const int kc = sh.r_k;
  // commits, one warp per verified target (each a distinct claim slot)
  for (int q = warp; q < kc; q += NWARP) {
    const int j = sh.worder[q], n = sh.wtgt[j];
    for (int r = lane; r < R; r += 32) {
      I32(cmax_alloc)[(long long)n * R + r] = S.wcmax[j * R + r];
      I32(crequests)[(long long)n * R + r] += sh.preq[r];
    }
    for (int w = lane; w < IW; w += 32) I32(alive)[(long long)n * IW + w] = S.wfi[j * IW + w];
    copy_row<true>(ROW(creq, n), row_of(S.wfin, j));
    if (lane == 0) {
      keys_put(S.kc.c, n, keys_at(S.wkeys, j), bnd_at(S.wkeys, j));
      I32(count)[n] += 1;
      I32(seq)[n] = max(I32(seq)[n], sh.nseq + q);
      I32(kinds)[p + q] = KIND_CLAIM;
      I32(slots)[p + q] = n;
    }
  }
  // topology records in window order
  for (int q = 0; q < kc; ++q) {
    const int j = sh.worder[q], n = sh.wtgt[j];
    record_window_row(p + q, window_row(S, j, k), E + n, true);
  }
  __syncthreads();
  if (tid == 0) sh.nseq += kc;
  __syncthreads();
  prof_mark(PH_level_commit);
  return kc;
}

// a lone feasible claim absorbs a whole window, capped by its pod-units
__device__ __noinline__ int case_solo(int p, int rem, const Scratch& S, int s) {
  const int tid = threadIdx.x, E = A.E, R = A.R, IW = A.IW;
  WorkRow& F = wrow(0);
  build_row<false>(F, ROW(creq, s), keys_at(S.kc.c, s), E + s, true);
  for (int r = tid; r < R; r += NT) F.total[r] = I32(crequests)[(long long)s * R + r] + sh.preq[r];
  __syncthreads();
  prof_mark(PH_solo_rows);
  type_filter<false>(F, 0, s);
  int best = 0;
  for (int i = tid; i < A.I; i += NT)
    if (fi_bit(F.fi, i)) best = max(best, type_units(i, I32(crequests) + (long long)s * R, sh.preq));
  best = block_reduce(best, RED_MAX);
  const int k = min(rem, min(min(best, h_budget(E + s)), KTPU_RUN_W));
  if (k <= 0) {
    if (tid == 0) S.excl_c[s] = 1;
    __syncthreads();
    prof_mark(PH_solo_filter);
    return 0;
  }
  // the types surviving the k-pod load
  for (int r = tid; r < R; r += NT) F.total[r] = I32(crequests)[(long long)s * R + r] + k * sh.preq[r];
  __syncthreads();
  type_filter<false>(F, 0, s);
  surviving_max_alloc<false>(F);
  prof_mark(PH_solo_filter);
  for (int r = tid; r < R; r += NT) {
    I32(cmax_alloc)[(long long)s * R + r] = F.red[r];
    I32(crequests)[(long long)s * R + r] += k * sh.preq[r];
  }
  for (int w = tid; w < IW; w += NT) I32(alive)[(long long)s * IW + w] = (int)F.fi[w];
  write_row<false>(ROW(creq, s), F);
  for (int j = tid; j < k; j += NT) {
    I32(kinds)[p + j] = KIND_CLAIM;
    I32(slots)[p + j] = s;
  }
  if (tid == 0) {
    keys_put(S.kc.c, s, F.fk, F.fbnd);
    I32(count)[s] += k;
    I32(seq)[s] = sh.nseq + k - 1;
  }
  const FinalRow f = final_of(F);
  for (int j = 0; j < k; ++j) record_window_row(p + j, f, E + s, true);
  __syncthreads();
  if (tid == 0) sh.nseq += k;
  __syncthreads();
  prof_mark(PH_solo_commit);
  return k;
}

// fresh claims from template t on slots m.., each filled to cstar pods
__device__ __noinline__ int case_new(int p, int rem, const Scratch& S, int& oflow) {
  const int tid = threadIdx.x, lane = tid & 31, E = A.E, N = A.N, R = A.R, IW = A.IW, I = A.I;
  const int t = sh.r_t, m = sh.n_claims;
  if (m >= N) {
    oflow = 1;
    return 0;
  }
  WorkRow& F = wrow(0);
  // cstar > 0: capt[t] > 0 by viability, and hostname budgets start >= 1
  const int cstar = max(min(S.capt[t], sh.r_hbf), 1);
  int ncl = min(min((rem + cstar - 1) / cstar, N - m), max(KTPU_RUN_W / cstar, 1));
  const int f = min(rem, min(ncl * cstar, KTPU_RUN_W));
  ncl = (f + cstar - 1) / cstar;
  const int last_fill = f - (ncl - 1) * cstar;
  stage_final<false>(F, row_of(S.final_t, t), keys_at(S.fkeys_t, t), bnd_at(S.fkeys_t, t));
  prof_mark(PH_new_rows);
  // two fill levels: F.fi for full claims, sh.fi2 for the last one
  for (int base = 0; base < IW * 32; base += NT) {
    const int i = base + tid;
    bool full = false, last = false;
    if (i < I && ((unsigned)S.alive_t[t * IW + (i >> 5)] >> (i & 31)) & 1u) {
      const int per = type_units(i, I32(tdaemon) + t * R, sh.preq);
      full = per >= cstar;
      last = per >= last_fill;
    }
    const unsigned wf = __ballot_sync(FULL_MASK, full), wl = __ballot_sync(FULL_MASK, last);
    if (lane == 0 && (i >> 5) < IW) {
      F.fi[i >> 5] = wf;
      sh.fi2[i >> 5] = wl;
    }
  }
  for (int r = tid; r < R; r += NT) {
    F.red[r] = -INF_I;
    sh.red2[r] = -INF_I;
  }
  __syncthreads();
  for (int i = tid; i < I; i += NT) {
    const bool full = fi_bit(F.fi, i), last = fi_bit(sh.fi2, i);
    for (int r = 0; r < R; ++r) {
      const int v = sh.t_alloc[(long long)r * I + i];
      if (full) atomicMax(&F.red[r], v);
      if (last) atomicMax(&sh.red2[r], v);
    }
  }
  __syncthreads();
  prof_mark(PH_new_filter);
  for (int j = 0; j < ncl; ++j) {
    const int idx = m + j;
    const int fill = min(max(f - j * cstar, 0), cstar);
    const bool full = fill == cstar;
    for (int r = tid; r < R; r += NT) {
      I32(crequests)[(long long)idx * R + r] = I32(tdaemon)[t * R + r] + fill * sh.preq[r];
      I32(cmax_alloc)[(long long)idx * R + r] = full ? F.red[r] : sh.red2[r];
    }
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)idx * IW + w] = (int)(full ? F.fi[w] : sh.fi2[w]);
    write_row<false>(ROW(creq, idx), F);
    if (tid == 0) {
      keys_put(S.kc.c, idx, F.fk, F.fbnd);
      I32(count)[idx] = fill;
      U8(active)[idx] = 1;
      I32(tmpl)[idx] = t;
      // claim j's last fill event: cumulative pods through it
      I32(seq)[idx] = sh.nseq + min(f, (j + 1) * cstar) - 1;
    }
  }
  for (int j = tid; j < f; j += NT) {
    I32(kinds)[p + j] = KIND_NEW;
    I32(slots)[p + j] = m + min(j / cstar, N - 1);
  }
  const FinalRow fr = final_of(F);
  for (int j = 0; j < f; ++j) record_window_row(p + j, fr, E + min(m + j / cstar, N - 1), true);
  __syncthreads();
  if (tid == 0) {
    *I32(n_claims) = m + ncl;
    sh.nseq += f;
  }
  __syncthreads();
  prof_mark(PH_new_commit);
  return f;
}

// One bulk window at pod p, after stage_pod(p); returns the pods decided.
__device__ __noinline__ int bulk_step(int p, const Scratch& S, int& oflow) {
  const int tid = threadIdx.x, E = A.E, N = A.N, T = A.T, R = A.R, IW = A.IW;
  const int rem = I32(run_rem)[p];
  for (int c = tid; c < A.C; c += NT) {
    const int kind = sh.ckind[c], gid = clampi(sh.cgid[c], 0, A.Gh - 1);
    sh.hgid[c] = gid;
    sh.hdyn[c] = sh.csel[c] && (kind == TOPO_SPREAD_H || kind == TOPO_ANTI_H);
    sh.hcap0[c] = kind == TOPO_SPREAD_H ? I32(h_skew)[clampi(gid, 0, A.GhS - 1)] : 1;
  }
  __syncthreads();
  // claim feasibility into cand; existing-node capacities into caps
  int nfeas = 0, first = INT_MAX;
  for (int n = tid; n < N; n += NT) {
    bool ok = U8(active)[n] && S.ok_c[n] && !S.excl_c[n];
    for (int r = 0; r < R && ok; ++r)
      if (I32(crequests)[(long long)n * R + r] + sh.preq[r] > I32(cmax_alloc)[(long long)n * R + r]) ok = false;
    if (ok) {
      bool types = false;
      for (int w = 0; w < IW && !types; ++w) types = (I32(alive)[(long long)n * IW + w] & sh.typeok[w]) != 0;
      ok = types;
    }
    ok = ok && h_budget(E + n) > 0;
    U8(cand)[n] = ok;
    if (ok) {
      ++nfeas;
      first = min(first, n);
    }
  }
  bool any_e = false;
  for (int e = tid; e < E; e += NT) {
    const int hb = h_budget(e);
    const bool ok = S.ok_e[e] && S.cape[e] > 0 && hb > 0;
    S.caps[e] = ok ? min(S.cape[e], hb) : 0;
    any_e = any_e || ok;
  }
  nfeas = block_reduce(nfeas, RED_SUM);
  first = block_reduce(first, RED_MIN);
  any_e = __syncthreads_or(any_e);
  if (tid < 32) {
    // the first workable template and the hostname budget floor
    int tf = INT_MAX, hbf = INF_I;
    for (int t = tid; t < T; t += 32)
      if (S.ok_t[t] && S.capt[t] > 0) tf = min(tf, t);
    for (int c = tid; c < A.C; c += 32)
      if (sh.hdyn[c]) hbf = min(hbf, sh.hcap0[c]);
    tf = __reduce_min_sync(FULL_MASK, tf);
    hbf = __reduce_min_sync(FULL_MASK, hbf);
    if (tid == 0) {
      const int t_first = tf == INT_MAX ? -1 : tf;
      sh.r_t = t_first;
      sh.r_hbf = hbf;
      sh.r_case = any_e ? CASE_EXISTING
                  : nfeas > 1 ? CASE_LEVEL
                  : nfeas == 1 ? CASE_SOLO
                  : t_first >= 0 ? CASE_NEW
                                 : CASE_FAIL;
    }
  }
  __syncthreads();
  prof_mark(PH_bulk_screen);
  switch (sh.r_case) {
    case CASE_EXISTING:
      return case_existing(p, rem, S);
    case CASE_LEVEL:
      return case_level(p, rem, S);
    case CASE_SOLO:
      return case_solo(p, rem, S, first);
    case CASE_NEW:
      return case_new(p, rem, S, oflow);
    default:
      return min(rem, KTPU_RUN_W);  // no target: the window fails
  }
}

// ---------------------------------------------------------------------------
// the kernel

// working rows: the CTA's and one per warp (the bulk windows)
#define RUN_ROWS (1 + NWARP)

__global__ void __launch_bounds__(NT, 1) run_step_kernel() {
  const int tid = threadIdx.x, N = A.N;
  prof_begin();
  Scratch S;
  carve((char*)A.scratch, A, S);
  step_prologue(A.SMB, RUN_ROWS, S.kc);
  if (tid == 0) sh.nseq = I32(counters)[3];
  __syncthreads();
  prof_mark(PH_prologue);
  int ptr = 0, over = 0, steps = 0, bulk_steps = 0;
  // built_at: the head whose run cache is live; idle: steps in a row that
  // committed nothing (the progress guard's count)
  int built_at = -1, idle = 0, stalled = 0;
  bool rc_active = false;
  while (ptr < A.n_valid && !over) {
    const bool head = U8(is_head)[ptr], is_bulk = U8(bulk)[ptr], is_aff = U8(aff)[ptr], valid = U8(valid)[ptr];
    stage_pod(ptr);
    prof_mark(PH_stage_pod);
    // non-affinity bulk heads build the cache up front and commit their own
    // pod through the bulk window; a retry at the same head keeps the cache,
    // so the claims the last step excluded stay excluded
    const bool head_build = head && is_bulk && !is_aff && valid;
    if (head_build && ptr != built_at) {
      build_cache(ptr, S);
      rc_active = true;
      built_at = ptr;
    }
    int k, oflow = 0;
    if (rc_active && is_bulk && (head_build || !head)) {
      k = bulk_step(ptr, S, oflow);
      ++bulk_steps;
    } else {
      // the seq key is a monotone transform of the rank order, and the step
      // only uses rank for min-selection, so the key stands in for it
      for (int n = tid; n < N; n += NT) I32(rank)[n] = seq_key(I32(count)[n], I32(seq)[n], U8(active)[n]);
      __syncthreads();
      prof_mark(PH_seq_rank);
      const int m = sh.n_claims;
      int kind, slot;
      if (A.relax) {
        const int trips = relax_step(ptr, S.kc, kind, oflow, slot);
        if (tid == 0) tier_tick(trips);
      } else {
        slot = exact_step(S.kc, kind, oflow);
      }
      if (tid == 0) {
        I32(kinds)[ptr] = kind;
        I32(slots)[ptr] = slot;
        const bool upd = kind == KIND_CLAIM || kind == KIND_NEW;
        const int sslot = kind == KIND_CLAIM ? slot : m;
        if (upd && sslot < N) I32(seq)[sslot] = sh.nseq;
        sh.nseq += upd;
      }
      __syncthreads();
      prof_mark(PH_other);
      if (is_bulk && I32(run_rem)[ptr] > 1 && valid && !oflow) {
        stage_pod(ptr);
        prof_mark(PH_stage_pod);
        build_cache(ptr, S);
        rc_active = true;
      } else {
        rc_active = false;
      }
      // an overflowing pod is not decided: ptr stays on it
      k = oflow ? 0 : 1;
    }
    ++steps;
    // the progress guard: each step that commits nothing excludes a claim,
    // so more than N + 1 in a row at one ptr is a walk gone wrong
    idle = (k == 0 && !oflow) ? idle + 1 : 0;
    if (idle > N + 1) {
      stalled = 1;
      break;
    }
    ptr += k;
    over |= oflow;
    __syncthreads();
    prof_mark(PH_other);
  }
  if (tid == 0) {
    I32(counters)[0] = over;
    I32(counters)[1] = steps;
    I32(counters)[2] = bulk_steps;
    I32(counters)[3] = sh.nseq;
    I32(counters)[4] = ptr;
    I32(counters)[KTPU_CNT_STALL] = stalled;
  }
  prof_end();
}

KTPU_STEP_EXPORTS(run_step)

extern "C" long long run_step_scratch_bytes(const StepArgs* args) {
  Scratch s;
  return (long long)carve(nullptr, *args, s);
}

extern "C" int run_step_launch(const StepArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  StepArgs a = *args;
  size_t dyn = 0;
  const int err = step_smem((const void*)run_step_kernel, a, RUN_ROWS, &dyn);
  if (err != 0) return err;
  const cudaError_t e = cudaMemcpyToSymbolAsync(A, &a, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  run_step_kernel<<<1, NT, dyn, s>>>();
  return (int)cudaGetLastError();
}
