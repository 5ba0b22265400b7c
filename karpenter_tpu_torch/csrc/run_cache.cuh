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
// scratch: the run cache and the window rows, carved from one block

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
  uint8_t* ok_c;    // [N] compat + tolerations + topology (pre-capacity)
  uint8_t* excl_c;  // [N] exact-verify failures of this run
  uint8_t* ok_e;    // [E]
  int* cape;        // [E] pod-units left
  int* caps;        // [E] this window's per-node capacity
  uint8_t* ok_t;    // [T] fully viable
  int* capt;        // [T] pod-units of a fresh claim
  int* alive_t;     // [T, IW] surviving types of a fresh claim
  RowBuf final_t;   // [T] rows a fresh claim writes
  RowBuf wfin;      // [RUN_W] the window's final rows
  int* wfi;         // [RUN_W, IW] the window's surviving types
};

struct Carver {
  char* base;  // null: only size
  size_t off;
  __host__ __device__ char* take(size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = (off + bytes + 15) & ~(size_t)15;
    return p;
  }
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
  s.ok_c = (uint8_t*)c.take(a.N);
  s.excl_c = (uint8_t*)c.take(a.N);
  s.ok_e = (uint8_t*)c.take(a.E);
  s.cape = (int*)c.take((size_t)a.E * 4);
  s.caps = (int*)c.take((size_t)a.E * 4);
  s.ok_t = (uint8_t*)c.take(a.T);
  s.capt = (int*)c.take((size_t)a.T * 4);
  s.alive_t = (int*)c.take((size_t)a.T * a.IW * 4);
  s.final_t = carve_rows(c, a.T, a.TW, a.K);
  s.wfin = carve_rows(c, KTPU_RUN_W, a.TW, a.K);
  s.wfi = (int*)c.take((size_t)KTPU_RUN_W * a.IW * 4);
  return c.off;
}

__device__ __forceinline__ Row row_of(const RowBuf& b, int i) {
  const int TW = A.TW, K = A.K;
  return Row{b.mask + (long long)i * TW, b.exmask + (long long)i * TW, b.other + (long long)i * K,
             b.notin + (long long)i * K, b.defined + (long long)i * K, b.gt + (long long)i * K,
             b.lt + (long long)i * K, b.minv + (long long)i * K};
}

// Load a stored final row into the working row (sh.f*, sh.fk); all threads.
__device__ void stage_final(const Row& r) {
  const int tid = threadIdx.x;
  __syncthreads();  // the previous working row's readers are done
  for (int w = tid; w < A.TW; w += NT) {
    sh.fmask[w] = r.mask[w];
    sh.fex[w] = r.exmask[w];
  }
  for (int k = tid; k < A.K; k += NT) {
    sh.fgt[k] = r.gt[k];
    sh.flt[k] = r.lt[k];
    sh.fminv[k] = r.minv[k];
  }
  if (tid == 0) sh.fk = row_keys(r, sh.w2k, A.TW, A.K);
  __syncthreads();
}

// tpu_runs.py _pod_units of (a - sub) for the pod's request: min over
// requested dims of floor(avail / req), 0 if any dim is negative.
__device__ int pod_units(const int* a, const int* sub, const int* preq) {
  bool nonneg = true;
  int units = INF_I;
  for (int r = 0; r < A.R; ++r) {
    const int av = a[r] - (sub ? sub[r] : 0);
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

__device__ void build_cache(int p, const Scratch& S) {
  const int tid = threadIdx.x;
  const int E = A.E, N = A.N, T = A.T, R = A.R, TW = A.TW, K = A.K;
  for (int n = tid; n < N; n += NT) {
    bool ok = U8(tol_t)[(long long)p * T + clampi(I32(tmpl)[n], 0, T > 0 ? T - 1 : 0)];
    if (ok) {
      const Row a = ROW(creq, n);
      const RowKeys ak = row_keys(a, sh.w2k, TW, K);
      const u64 conflict = conflict_keys(a.mask, a.gt, a.lt, ak, sh.pmask, sh.pgt, sh.plt, sh.pk, sh.w2k, TW, K);
      ok = compat_keys(conflict, ak, sh.pk, true, sh.well_known);
      if (ok) {
        const u64 collapse = collapse_keys(a.gt, a.lt, sh.pgt, sh.plt, K);
        u64 touched;
        TopoOut t;
        ok = topo_eval(a.mask, collapse, E + n, touched, t) && nonempty_ok(a.mask, collapse, t);
      }
    }
    S.ok_c[n] = ok;
    S.excl_c[n] = 0;
  }
  for (int e = tid; e < E; e += NT) {
    bool ok = U8(tol_e)[(long long)p * E + e];
    if (ok) {
      const Row a = ROW(ereq, e);
      const RowKeys ak = row_keys(a, sh.w2k, TW, K);
      const u64 conflict = conflict_keys(a.mask, a.gt, a.lt, ak, sh.pmask, sh.pgt, sh.plt, sh.pk, sh.w2k, TW, K);
      ok = compat_keys(conflict, ak, sh.pk, false, sh.well_known);
      if (ok) {
        const u64 collapse = collapse_keys(a.gt, a.lt, sh.pgt, sh.plt, K);
        u64 touched;
        TopoOut t;
        ok = topo_eval(a.mask, collapse, e, touched, t) && nonempty_ok(a.mask, collapse, t);
      }
    }
    S.ok_e[e] = ok;
    S.cape[e] = pod_units(I32(eavail) + (long long)e * R, nullptr, sh.preq);
  }
  for (int t = 0; t < T; ++t) {
    build_row(ROW(treq, t), -1, true);
    for (int r = tid; r < R; r += NT) sh.total[r] = I32(tdaemon)[t * R + r] + sh.preq[r];
    __syncthreads();
    const bool any = type_filter(2, t);
    int best = 0;
    for (int i = tid; i < A.I; i += NT)
      if (fi_bit(sh.fi, i)) best = max(best, pod_units(I32(ialloc) + (long long)i * R, I32(tdaemon) + t * R, sh.preq));
    best = block_reduce(best, RED_MAX);
    if (tid == 0) {
      S.ok_t[t] = any && sh.row_compat && sh.row_viable && (sh.ftouched & ~sh.fsegm) == 0 &&
                  U8(tol_t)[(long long)p * T + t];
      S.capt[t] = best;
    }
    write_row(row_of(S.final_t, t));
    for (int w = tid; w < A.IW; w += NT) S.alive_t[t * A.IW + w] = (int)sh.fi[w];
    __syncthreads();
  }
}
