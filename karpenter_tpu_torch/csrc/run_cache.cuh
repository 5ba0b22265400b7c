// The run cache (tpu_runs.py `_build_cache`) and the scratch block it
// lives in, shared by K3 run_step (run_step.cu) and the consolidation
// sweeps K6 fast_sweep and K8 set_sweep (sweep_core.cuh), which build the
// cache once for their representative pod and read its existing-node and
// template screens and final template rows.
//
// Include after step.cuh: the cache build uses the step's staging, working
// row and type filter.
#pragma once
#include "step.cuh"

// ---------------------------------------------------------------------------
// scratch: the key caches, the run cache and the window rows, carved from
// one block

struct RowBuf {  // n requirement rows, field by field
  int* mask;
  int* exmask;
  uint8_t* other;
  uint8_t* notin;
  uint8_t* defined;
  int* gt;
  int* lt;
  int* minv;
};

struct Scratch {
  KeyCache kc;      // the claim slots' and existing nodes' key masks
  uint8_t* ok_c;    // [N] compat + tolerations + topology (pre-capacity)
  uint8_t* excl_c;  // [N] exact-verify failures of this run
  uint8_t* ok_e;    // [E]
  int* cape;        // [E] pod-units left
  int* caps;        // [E] this window's per-node capacity
  uint8_t* ok_t;    // [T] fully viable
  int* capt;        // [T] pod-units of a fresh claim
  int* alive_t;     // [T, IW] surviving types of a fresh claim
  RowBuf final_t;   // [T] rows a fresh claim writes
  KeyRows fkeys_t;  // [5, T] and their key masks
  RowBuf wfin;      // [RUN_W] the window's final rows
  KeyRows wkeys;    // [5, RUN_W] and their key masks
  int* wfi;         // [RUN_W, IW] the window's surviving types
  int* wcmax;       // [RUN_W, R] and their allocatable column max
};

__host__ __device__ inline RowBuf carve_rows(Carver& c, int n, int TW, int K) {
  RowBuf r;
  r.mask = (int*)c.take((size_t)n * TW * 4);
  r.exmask = (int*)c.take((size_t)n * TW * 4);
  r.other = (uint8_t*)c.take((size_t)n * K);
  r.notin = (uint8_t*)c.take((size_t)n * K);
  r.defined = (uint8_t*)c.take((size_t)n * K);
  r.gt = (int*)c.take((size_t)n * K * 4);
  r.lt = (int*)c.take((size_t)n * K * 4);
  r.minv = (int*)c.take((size_t)n * K * 4);
  return r;
}

// Pointers into the scratch block at `base`; returns its size in bytes.
__host__ __device__ inline size_t carve(char* base, const StepArgs& a, Scratch& s) {
  Carver c{base, 0};
  carve_key_cache(c, a, s.kc);
  s.ok_c = (uint8_t*)c.take(a.N);
  s.excl_c = (uint8_t*)c.take(a.N);
  s.ok_e = (uint8_t*)c.take(a.E);
  s.cape = (int*)c.take((size_t)a.E * 4);
  s.caps = (int*)c.take((size_t)a.E * 4);
  s.ok_t = (uint8_t*)c.take(a.T);
  s.capt = (int*)c.take((size_t)a.T * 4);
  s.alive_t = (int*)c.take((size_t)a.T * a.IW * 4);
  s.final_t = carve_rows(c, a.T, a.TW, a.K);
  s.fkeys_t = carve_keys(c, a.T);
  s.wfin = carve_rows(c, KTPU_RUN_W, a.TW, a.K);
  s.wkeys = carve_keys(c, KTPU_RUN_W);
  s.wfi = (int*)c.take((size_t)KTPU_RUN_W * a.IW * 4);
  s.wcmax = (int*)c.take((size_t)KTPU_RUN_W * a.R * 4);
  return c.off;
}

__device__ __forceinline__ Row row_of(const RowBuf& b, int i) {
  const int TW = A.TW, K = A.K;
  return Row{b.mask + (long long)i * TW, b.exmask + (long long)i * TW, b.other + (long long)i * K,
             b.notin + (long long)i * K, b.defined + (long long)i * K, b.gt + (long long)i * K,
             b.lt + (long long)i * K, b.minv + (long long)i * K};
}

// Copy a stored row into a row of the state; the whole team.
template <bool WARP>
__device__ void copy_row(const Row& dst, const Row& src) {
  typedef Team<WARP> G;
  const int tid = G::rank();
  for (int w = tid; w < A.TW; w += G::size) {
    ((int*)dst.mask)[w] = src.mask[w];
    ((int*)dst.exmask)[w] = src.exmask[w];
  }
  for (int k = tid; k < A.K; k += G::size) {
    ((uint8_t*)dst.other)[k] = src.other[k];
    ((uint8_t*)dst.notin)[k] = src.notin[k];
    ((uint8_t*)dst.defined)[k] = src.defined[k];
    ((int*)dst.gt)[k] = src.gt[k];
    ((int*)dst.lt)[k] = src.lt[k];
    ((int*)dst.minv)[k] = src.minv[k];
  }
}

// tpu_runs.py _pod_units of an availability row for the pod's request:
// min over requested dims of floor(avail / req), 0 if any dim is negative.
__device__ int pod_units(const int* a, const int* preq) {
  bool nonneg = true;
  int units = INF_I;
  for (int r = 0; r < A.R; ++r) {
    const int av = a[r];
    if (av < 0)
      nonneg = false;
    else if (preq[r] > 0)
      units = min(units, av / preq[r]);
  }
  return nonneg ? max(units, 0) : 0;
}

// _pod_units of type i's allocatable (the staged [R, I] table) less `sub`
__device__ int type_units(int i, const int* sub, const int* preq) {
  bool nonneg = true;
  int units = INF_I;
  for (int r = 0; r < A.R; ++r) {
    const int av = sh.t_alloc[(long long)r * A.I + i] - sub[r];
    if (av < 0)
      nonneg = false;
    else if (preq[r] > 0)
      units = min(units, av / preq[r]);
  }
  return nonneg ? max(units, 0) : 0;
}

__device__ __forceinline__ bool fi_bit(const unsigned* words, int i) { return (words[i >> 5] >> (i & 31)) & 1u; }

// ---------------------------------------------------------------------------
// the run cache (tpu_runs.py _build_cache), after stage_pod(p)

// existing node e's screen and pod-units; one thread
__device__ __forceinline__ void cache_existing(int p, const Scratch& S, int e) {
  bool ok = U8(tol_e)[(long long)p * A.E + e];
  if (ok) ok = screen_row(ROW(ereq, e), keys_at(S.kc.e, e), bnd_at(S.kc.e, e), e, false);
  S.ok_e[e] = ok;
  S.cape[e] = pod_units(I32(eavail) + (long long)e * A.R, sh.preq);
}

// template t's screen, fresh-claim units, final row and surviving types;
// all threads call
__device__ __forceinline__ void cache_template(int p, const Scratch& S, int t) {
  const int tid = threadIdx.x, T = A.T, R = A.R;
  WorkRow& F = wrow(0);
  build_row<false>(F, ROW(treq, t), tmpl_keys(t), -1, true);
  for (int r = tid; r < R; r += NT) F.total[r] = I32(tdaemon)[t * R + r] + sh.preq[r];
  __syncthreads();
  const bool any = type_filter<false>(F, 2, t);
  int best = 0;
  for (int i = tid; i < A.I; i += NT)
    if (fi_bit(F.fi, i)) best = max(best, type_units(i, I32(tdaemon) + t * R, sh.preq));
  best = block_reduce(best, RED_MAX);
  if (tid == 0) {
    S.ok_t[t] = any && F.row_compat && F.row_viable && (F.ftouched & ~F.fsegm) == 0 &&
                U8(tol_t)[(long long)p * T + t];
    S.capt[t] = best;
    keys_put(S.fkeys_t, t, F.fk, F.fbnd);
  }
  write_row<false>(row_of(S.final_t, t), F);
  for (int w = tid; w < A.IW; w += NT) S.alive_t[t * A.IW + w] = (int)F.fi[w];
  __syncthreads();
}

__device__ __noinline__ void build_cache(int p, const Scratch& S) {
  const int tid = threadIdx.x;
  const int E = A.E, N = A.N, T = A.T;
  for (int n = tid; n < N; n += NT) {
    bool ok = U8(tol_t)[(long long)p * T + clampi(I32(tmpl)[n], 0, T > 0 ? T - 1 : 0)];
    if (ok) ok = screen_row(ROW(creq, n), keys_at(S.kc.c, n), bnd_at(S.kc.c, n), E + n, true);
    S.ok_c[n] = ok;
    S.excl_c[n] = 0;
  }
  prof_sync(PH_cache_claims);
  for (int e = tid; e < E; e += NT) cache_existing(p, S, e);
  prof_sync(PH_cache_existing);
  for (int t = 0; t < T; ++t) cache_template(p, S, t);
  prof_mark(PH_cache_templates);
}
