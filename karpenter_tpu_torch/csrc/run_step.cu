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
//     over the claims and existing nodes, and runs it: each target's final
//     row is built in shared memory in turn (the type filter over I types
//     in parallel) and kept in a window scratch; the commits and the
//     topology records follow once every row is built, so all rows see the
//     state before the window;
//   - otherwise writes the claims' seq key into `rank`, takes the exact
//     step (with relax, the tier loop relax_step, every tier reusing that
//     key), and (for a bulkable run with pods left) builds the cache.
//     Tiered classes are never bulk, so no window and no cache build sees
//     a tier's rows; a cache build restages the pod's own rows.
// Counters (overflow, steps, bulk_steps, next_seq, ptr, tier_steps,
// tier_hist) go to `counters`.
//
// Bound on an H100: bytes (a cache build reads every claim row, a window
// its targets' rows: a few MB that stay in L2); in practice the walk is a
// dependent chain of block reductions and barriers, so its time is their
// latency. This first version keeps the whole walk in one launch and leaves
// spreading a window's rows over warps to a later one.
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

// the topology record of the working row for the pod at position j
__device__ void record_window_row(int j, int slot_global, bool allow_wk) {
  record_row(slot_global, allow_wk, sel_row(A.sel_v, j, A.Gv), sel_row(A.sel_h, j, A.Gh), sel_row(A.own_h, j, A.Gh));
}

__device__ void copy_row(const Row& dst, const Row& src) {
  const int tid = threadIdx.x;
  for (int w = tid; w < A.TW; w += NT) {
    ((int*)dst.mask)[w] = src.mask[w];
    ((int*)dst.exmask)[w] = src.exmask[w];
  }
  for (int k = tid; k < A.K; k += NT) {
    ((uint8_t*)dst.other)[k] = src.other[k];
    ((uint8_t*)dst.notin)[k] = src.notin[k];
    ((uint8_t*)dst.defined)[k] = src.defined[k];
    ((int*)dst.gt)[k] = src.gt[k];
    ((int*)dst.lt)[k] = src.lt[k];
    ((int*)dst.minv)[k] = src.minv[k];
  }
}

// ---------------------------------------------------------------------------
// bulk cases; each returns the pods it decided (the window's k)

// existing nodes first-fill by cumulative capacity, in node order
__device__ int case_existing(int p, int rem, const Scratch& S) {
  const int tid = threadIdx.x, E = A.E, R = A.R;
  if (tid == 0) {
    unsigned total = 0;  // int32 wrapping sum, as the reference's
    for (int e = 0; e < E; ++e) total += (unsigned)S.caps[e];
    const int k = min(rem, min((int)total, KTPU_RUN_W));
    int j = 0;
    for (int e = 0; e < E && j < k; ++e)
      for (int c = 0; c < S.caps[e] && j < k; ++c) sh.wtgt[j++] = e;
    sh.r_k = max(k, 0);
  }
  __syncthreads();
  const int k = sh.r_k;
  // the final row of each distinct target, against the state before the window
  for (int j = 0; j < k; ++j) {
    if (j > 0 && sh.wtgt[j] == sh.wtgt[j - 1]) continue;
    build_row(ROW(ereq, sh.wtgt[j]), sh.wtgt[j], false);
    write_row(row_of(S.wfin, j));
    __syncthreads();
  }
  // commits, one distinct target at a time
  for (int j = 0; j < k;) {
    const int e = sh.wtgt[j];
    int j1 = j;
    while (j1 < k && sh.wtgt[j1] == e) ++j1;
    const int added = j1 - j;
    for (int r = tid; r < R; r += NT) I32(eavail)[(long long)e * R + r] -= added * sh.preq[r];
    copy_row(ROW(ereq, e), row_of(S.wfin, j));
    if (tid == 0) S.cape[e] -= added;
    stage_final(row_of(S.wfin, j));
    for (int q = j; q < j1; ++q) record_window_row(p + q, e, false);
    j = j1;
  }
  for (int j = tid; j < k; j += NT) {
    I32(kinds)[p + j] = KIND_EXISTING;
    I32(slots)[p + j] = sh.wtgt[j];
  }
  __syncthreads();
  return k;
}

// one pod per feasible claim at the minimum count, in block order
__device__ int case_level(int p, int rem, const Scratch& S) {
  const int tid = threadIdx.x, E = A.E, N = A.N, R = A.R, IW = A.IW;
  int cm = INF_I;
  for (int n = tid; n < N; n += NT)
    if (U8(cand)[n]) cm = min(cm, I32(count)[n]);
  cm = block_reduce(cm, RED_MIN);
  int nl = 0;
  for (int n = tid; n < N; n += NT) nl += U8(cand)[n] && I32(count)[n] == cm;
  nl = block_reduce(nl, RED_SUM);
  const int k = min(rem, min(nl, KTPU_RUN_W));
  // the k smallest (key, index) of the level, like lax.top_k
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
  // final rows and the exact type verify of the grown request
  for (int j = 0; j < k; ++j) {
    const int n = sh.wtgt[j];
    build_row(ROW(creq, n), E + n, true);
    for (int r = tid; r < R; r += NT) sh.total[r] = I32(crequests)[(long long)n * R + r] + sh.preq[r];
    __syncthreads();
    const bool ok = type_filter(0, n);
    write_row(row_of(S.wfin, j));
    for (int w = tid; w < IW; w += NT) S.wfi[j * IW + w] = (int)sh.fi[w];
    if (tid == 0) sh.wok[j] = ok;
    __syncthreads();
  }
  // verified targets go to the window front in window order; failures are
  // excluded for the rest of the run
  if (tid == 0) {
    int kc = 0;
    for (int j = 0; j < k; ++j) {
      if (sh.wok[j])
        sh.worder[kc++] = j;
      else
        S.excl_c[sh.wtgt[j]] = 1;
    }
    sh.r_k = kc;
  }
  __syncthreads();
  const int kc = sh.r_k;
  for (int q = 0; q < kc; ++q) {
    const int j = sh.worder[q], n = sh.wtgt[j];
    stage_final(row_of(S.wfin, j));
    for (int w = tid; w < IW; w += NT) sh.fi[w] = (unsigned)S.wfi[j * IW + w];
    surviving_max(I32(ialloc), -INF_I);
    for (int r = tid; r < R; r += NT) {
      I32(cmax_alloc)[(long long)n * R + r] = sh.red[r];
      I32(crequests)[(long long)n * R + r] += sh.preq[r];
    }
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)n * IW + w] = (int)sh.fi[w];
    write_row(ROW(creq, n));
    if (tid == 0) {
      I32(count)[n] += 1;
      I32(seq)[n] = max(I32(seq)[n], sh.nseq + q);
      I32(kinds)[p + q] = KIND_CLAIM;
      I32(slots)[p + q] = n;
    }
    record_window_row(p + q, E + n, true);
  }
  __syncthreads();
  if (tid == 0) sh.nseq += kc;
  __syncthreads();
  return kc;
}

// a lone feasible claim absorbs a whole window, capped by its pod-units
__device__ int case_solo(int p, int rem, const Scratch& S, int s) {
  const int tid = threadIdx.x, E = A.E, R = A.R, IW = A.IW;
  build_row(ROW(creq, s), E + s, true);
  for (int r = tid; r < R; r += NT) sh.total[r] = I32(crequests)[(long long)s * R + r] + sh.preq[r];
  __syncthreads();
  type_filter(0, s);
  int best = 0;
  for (int i = tid; i < A.I; i += NT)
    if (fi_bit(sh.fi, i))
      best = max(best, pod_units(I32(ialloc) + (long long)i * R, I32(crequests) + (long long)s * R, sh.preq));
  best = block_reduce(best, RED_MAX);
  const int k = min(rem, min(min(best, h_budget(E + s)), KTPU_RUN_W));
  if (k <= 0) {
    if (tid == 0) S.excl_c[s] = 1;
    __syncthreads();
    return 0;
  }
  // the types surviving the k-pod load
  for (int r = tid; r < R; r += NT) sh.total[r] = I32(crequests)[(long long)s * R + r] + k * sh.preq[r];
  __syncthreads();
  type_filter(0, s);
  surviving_max(I32(ialloc), -INF_I);
  for (int r = tid; r < R; r += NT) {
    I32(cmax_alloc)[(long long)s * R + r] = sh.red[r];
    I32(crequests)[(long long)s * R + r] += k * sh.preq[r];
  }
  for (int w = tid; w < IW; w += NT) I32(alive)[(long long)s * IW + w] = (int)sh.fi[w];
  write_row(ROW(creq, s));
  for (int j = tid; j < k; j += NT) {
    I32(kinds)[p + j] = KIND_CLAIM;
    I32(slots)[p + j] = s;
  }
  if (tid == 0) {
    I32(count)[s] += k;
    I32(seq)[s] = sh.nseq + k - 1;
  }
  for (int j = 0; j < k; ++j) record_window_row(p + j, E + s, true);
  __syncthreads();
  if (tid == 0) sh.nseq += k;
  __syncthreads();
  return k;
}

// fresh claims from template t on slots m.., each filled to cstar pods
__device__ int case_new(int p, int rem, const Scratch& S, int& oflow) {
  const int tid = threadIdx.x, lane = tid & 31, E = A.E, N = A.N, R = A.R, IW = A.IW;
  const int t = sh.r_t, m = sh.n_claims;
  if (m >= N) {
    oflow = 1;
    return 0;
  }
  // cstar > 0: capt[t] > 0 by viability, and hostname budgets start >= 1
  const int cstar = max(min(S.capt[t], sh.r_hbf), 1);
  int ncl = min(min((rem + cstar - 1) / cstar, N - m), max(KTPU_RUN_W / cstar, 1));
  const int f = min(rem, min(ncl * cstar, KTPU_RUN_W));
  ncl = (f + cstar - 1) / cstar;
  const int last_fill = f - (ncl - 1) * cstar;
  stage_final(row_of(S.final_t, t));
  // two fill levels: sh.fi for full claims, sh.fi2 for the last one
  for (int base = 0; base < IW * 32; base += NT) {
    const int i = base + tid;
    bool full = false, last = false;
    if (i < A.I && ((unsigned)S.alive_t[t * IW + (i >> 5)] >> (i & 31)) & 1u) {
      const int per = pod_units(I32(ialloc) + (long long)i * R, I32(tdaemon) + t * R, sh.preq);
      full = per >= cstar;
      last = per >= last_fill;
    }
    const unsigned wf = __ballot_sync(0xffffffffu, full), wl = __ballot_sync(0xffffffffu, last);
    if (lane == 0 && (i >> 5) < IW) {
      sh.fi[i >> 5] = wf;
      sh.fi2[i >> 5] = wl;
    }
  }
  for (int r = tid; r < R; r += NT) {
    sh.red[r] = -INF_I;
    sh.red2[r] = -INF_I;
  }
  __syncthreads();
  for (int i = tid; i < A.I; i += NT) {
    const bool full = fi_bit(sh.fi, i), last = fi_bit(sh.fi2, i);
    for (int r = 0; r < R; ++r) {
      const int v = I32(ialloc)[(long long)i * R + r];
      if (full) atomicMax(&sh.red[r], v);
      if (last) atomicMax(&sh.red2[r], v);
    }
  }
  __syncthreads();
  for (int j = 0; j < ncl; ++j) {
    const int idx = m + j;
    const int fill = min(max(f - j * cstar, 0), cstar);
    const bool full = fill == cstar;
    for (int r = tid; r < R; r += NT) {
      I32(crequests)[(long long)idx * R + r] = I32(tdaemon)[t * R + r] + fill * sh.preq[r];
      I32(cmax_alloc)[(long long)idx * R + r] = full ? sh.red[r] : sh.red2[r];
    }
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)idx * IW + w] = (int)(full ? sh.fi[w] : sh.fi2[w]);
    write_row(ROW(creq, idx));
    if (tid == 0) {
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
  for (int j = 0; j < f; ++j) record_window_row(p + j, E + min(m + j / cstar, N - 1), true);
  __syncthreads();
  if (tid == 0) {
    *I32(n_claims) = m + ncl;
    sh.nseq += f;
  }
  __syncthreads();
  return f;
}

// One bulk window at pod p, after stage_pod(p); returns the pods decided.
__device__ int bulk_step(int p, const Scratch& S, int& oflow) {
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
  if (tid == 0) {
    int t_first = -1;
    for (int t = 0; t < T && t_first < 0; ++t)
      if (S.ok_t[t] && S.capt[t] > 0) t_first = t;
    int hbf = INF_I;
    for (int c = 0; c < A.C; ++c)
      if (sh.hdyn[c]) hbf = min(hbf, sh.hcap0[c]);
    sh.r_t = t_first;
    sh.r_hbf = hbf;
    sh.r_case = any_e ? CASE_EXISTING
                : nfeas > 1 ? CASE_LEVEL
                : nfeas == 1 ? CASE_SOLO
                : t_first >= 0 ? CASE_NEW
                               : CASE_FAIL;
  }
  __syncthreads();
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

__global__ void __launch_bounds__(NT, 1) run_step_kernel() {
  const int tid = threadIdx.x, N = A.N;
  stage_vocab();
  Scratch S;
  carve((char*)A.scratch, A, S);
  if (tid == 0) sh.nseq = I32(counters)[3];
  __syncthreads();
  int ptr = 0, over = 0, steps = 0, bulk_steps = 0;
  bool rc_active = false;
  while (ptr < A.n_valid && !over) {
    const bool head = U8(is_head)[ptr], is_bulk = U8(bulk)[ptr], is_aff = U8(aff)[ptr], valid = U8(valid)[ptr];
    stage_pod(ptr);
    // non-affinity bulk heads build the cache up front and commit their own
    // pod through the bulk window
    const bool head_build = head && is_bulk && !is_aff && valid;
    if (head_build) {
      build_cache(ptr, S);
      rc_active = true;
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
      const int m = sh.n_claims;
      int kind, slot;
      if (A.relax) {
        const int trips = relax_step(ptr, kind, oflow, slot);
        if (tid == 0) tier_tick(trips);
      } else {
        slot = exact_step(kind, oflow);
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
      if (is_bulk && I32(run_rem)[ptr] > 1 && valid && !oflow) {
        stage_pod(ptr);
        build_cache(ptr, S);
        rc_active = true;
      } else {
        rc_active = false;
      }
      // an overflowing pod is not decided: ptr stays on it
      k = oflow ? 0 : 1;
    }
    ++steps;
    ptr += k;
    over |= oflow;
    __syncthreads();
  }
  if (tid == 0) {
    I32(counters)[0] = over;
    I32(counters)[1] = steps;
    I32(counters)[2] = bulk_steps;
    I32(counters)[3] = sh.nseq;
    I32(counters)[4] = ptr;
  }
}

#define KTPU_NAME(name) #name ","
static const char kFieldNames[] =
    KTPU_STEP_PTR_FIELDS(KTPU_NAME) "|" KTPU_STEP_INT_FIELDS(KTPU_NAME);
#undef KTPU_NAME

extern "C" const char* run_step_field_names() { return kFieldNames; }

extern "C" int run_step_args_size() { return (int)sizeof(StepArgs); }

extern "C" long long run_step_scratch_bytes(const StepArgs* args) {
  Scratch s;
  return (long long)carve(nullptr, *args, s);
}

extern "C" int run_step_launch(const StepArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(A, args, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  run_step_kernel<<<1, NT, 0, s>>>();
  return (int)cudaGetLastError();
}
