// The delta-state consolidation sweep core, shared by K6 fast_sweep
// (fast_sweep.cu) and K8 set_sweep (set_sweep.cu).
//
// Replaces karpenter_tpu/controllers/disruption/sweep.py:82
// `_ffd_feasibility_core` (with tpu_runs.py:185 `_build_cache` for the
// representative pod, which the reference's callers run first).
//
// Design. Two launches on one stream:
//   1. sweep_cache_kernel, one CTA: stage the representative pod (batch
//      row 0 of StepArgs), build the run cache (run_cache.cuh: the
//      existing-node screen ok_e, the template screen ok_t and the final
//      template rows) and the template-fit table fit1[t, c] (the type
//      filter of template t's final row at its daemon overhead plus one pod
//      of class c). Lane-independent, so built once.
//   2. the caller's lane kernel, <<<B, NT>>>: CTA b derives its lane (the
//      removed slots at -1 in its [E, R] availability, its class counts)
//      and runs lane_core: per class, every thread takes a contiguous chunk
//      of nodes, the chunk capacities go through a block-wide exclusive
//      scan, and each node takes min(max(count - before, 0), cap) pods in
//      place; then the lane's verdict: all pods placed, or the first
//      leftover class's first workable template hosts the whole leftover
//      total (one type filter over the I types).
// Everything is int32 and exact: the host's int64 guards
// (capacity_cumsum_fits_int32, the worst leftover total < 2^30) prove no
// sum wraps. A lane's first-index choices (c0, tstar) take index 0 when
// nothing qualifies, as jnp.argmax of all-false does.
//
// Bound on an H100: bytes. Each lane reads the base availability and
// writes its own copy once, then reads and rewrites it once per class.
#pragma once
#include "step.cuh"
#include "run_cache.cuh"

// The lanes' argument block, declared once (the Python wrapper builds its
// ctypes structure from <kernel>_sweep_field_names()). K6 reads cand_idx
// and counts, K8 slot_cand, member, base_counts and percand; a kernel
// ignores the other's fields.
#define KTPU_SWEEP_PTR_FIELDS(X)                                                             \
  /* [E, R] base availability, [C, R] class requests */                                     \
  X(avail0) X(sizes)                                                                         \
  /* work: [B, E, R] lane availability, [B, C] leftovers, [T, C] template fit (u8), */      \
  /* [B, C] lane class counts (K8) */                                                        \
  X(avail) X(left) X(fit1) X(lane_counts)                                                    \
  /* outputs: [B] verdicts (u8), [1] class-loop trips */                                    \
  X(feasible) X(steps)                                                                       \
  /* K6: [E] candidate index of each slot (1<<30: none), [B, C] lane counts */              \
  X(cand_idx) X(counts)                                                                      \
  /* K8: [E] candidate of each slot (J: none), [B, J] membership, [C] base, [J, C] P */     \
  X(slot_cand) X(member) X(base_counts) X(percand)

#define KTPU_SWEEP_INT_FIELDS(X) X(B) X(C) X(J) X(singleton)

struct SweepArgs {
#define KTPU_DECL_PTR(name) void* name;
  KTPU_SWEEP_PTR_FIELDS(KTPU_DECL_PTR)
#undef KTPU_DECL_PTR
#define KTPU_DECL_INT(name) int name;
  KTPU_SWEEP_INT_FIELDS(KTPU_DECL_INT)
#undef KTPU_DECL_INT
};

__constant__ SweepArgs SA;

#define SI32(f) ((int*)SA.f)
#define SU8(f) ((uint8_t*)SA.f)

// the lane verdict's scalars, set by thread 0
__shared__ int sw_tot[KTPU_MAX_R];
__shared__ int sw_any_left, sw_has_t, sw_tstar;

// ---------------------------------------------------------------------------
// launch 1: the run cache and the template-fit table

__global__ void __launch_bounds__(NT, 1) sweep_cache_kernel() {
  const int tid = threadIdx.x, R = A.R, C = SA.C;
  Scratch S;
  carve((char*)A.scratch, A, S);
  step_prologue(A.SMB, 1, S.kc);
  stage_pod(0);
  build_cache(0, S);
  WorkRow& F = wrow(0);
  for (int t = 0; t < A.T; ++t) {
    stage_final<false>(F, row_of(S.final_t, t), keys_at(S.fkeys_t, t), bnd_at(S.fkeys_t, t));
    for (int c = 0; c < C; ++c) {
      for (int r = tid; r < R; r += NT) F.total[r] = I32(tdaemon)[t * R + r] + SI32(sizes)[c * R + r];
      __syncthreads();
      const bool any = type_filter<false>(F, 2, t);
      if (tid == 0) SU8(fit1)[t * C + c] = any;
      __syncthreads();
    }
  }
  if (tid == 0) SI32(steps)[0] = C;
}

// ---------------------------------------------------------------------------
// launch 2: the lanes

// Block-wide exclusive scan of one int per thread (thread order); *total
// gets the block's sum. All threads call.
__device__ int block_exclusive_scan(int v, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh.bw[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < NWARP; ++w) {
    if (w < warp) before += sh.bw[w];
    sum += sh.bw[w];
  }
  __syncthreads();  // sh.bw is free again
  *total = sum;
  return before + x - v;
}

// Pods of one class (requests s) node a can take: min over requested dims
// of a[r] / s[r] (INF_I when nothing is requested), 0 on a removed or
// overcommitted node (a negative dim) or one the screen refuses.
__device__ __forceinline__ int node_cap(const int* a, const int* s, bool ok) {
  if (!ok) return 0;
  int cap = INF_I;
  bool nonneg = true;
  for (int r = 0; r < A.R; ++r) {
    if (a[r] < 0) nonneg = false;
    if (s[r] > 0) cap = min(cap, a[r] / s[r]);
  }
  return nonneg ? max(cap, 0) : 0;
}

// The class loop and the verdict of lane b over its availability `av`
// [E, R] (updated in place) and class counts `cnt` [C]. All threads call,
// after the lane's derivation and a barrier.
__device__ void lane_core(int b, int* av, const int* cnt) {
  const int tid = threadIdx.x, E = A.E, R = A.R, C = SA.C;
  Scratch S;
  carve((char*)A.scratch, A, S);
  const int chunk = (E + NT - 1) / NT;
  const int e0 = min(tid * chunk, E), e1 = min(e0 + chunk, E);
  int* left = SI32(left) + (long long)b * C;
  for (int c = 0; c < C; ++c) {
    const int* s = SI32(sizes) + c * R;
    int mine = 0;
    for (int e = e0; e < e1; ++e) mine += node_cap(av + (long long)e * R, s, S.ok_e[e]);
    int total;
    int before = block_exclusive_scan(mine, &total);
    const int want = cnt[c];
    int took = 0;
    for (int e = e0; e < e1; ++e) {
      int* a = av + (long long)e * R;
      const int cap = node_cap(a, s, S.ok_e[e]);
      const int take = min(max(want - before, 0), cap);
      if (take > 0)
        for (int r = 0; r < R; ++r) a[r] -= take * s[r];
      before += cap;
      took += take;
    }
    took = block_reduce(took, RED_SUM);
    if (tid == 0) left[c] = want - took;
  }
  __syncthreads();
  if (tid == 0) {
    int lsum = 0, c0 = -1;
    for (int c = 0; c < C; ++c) {
      lsum += left[c];
      if (c0 < 0 && left[c] > 0) c0 = c;
    }
    c0 = max(c0, 0);
    for (int r = 0; r < R; ++r) {
      int tot = 0;
      for (int c = 0; c < C; ++c) tot += left[c] * SI32(sizes)[c * R + r];
      sw_tot[r] = tot;
    }
    int tstar = -1;
    for (int t = 0; t < A.T && tstar < 0; ++t)
      if (S.ok_t[t] && SU8(fit1)[t * C + c0]) tstar = t;
    sw_any_left = lsum > 0;
    sw_has_t = tstar >= 0;
    sw_tstar = max(tstar, 0);
  }
  __syncthreads();
  bool ok = true;
  if (sw_any_left) {
    ok = false;
    if (sw_has_t) {
      const int t = sw_tstar;
      WorkRow& F = wrow(0);
      stage_final<false>(F, row_of(S.final_t, t), keys_at(S.fkeys_t, t), bnd_at(S.fkeys_t, t));
      for (int r = tid; r < R; r += NT) F.total[r] = I32(tdaemon)[t * R + r] + sw_tot[r];
      __syncthreads();
      ok = type_filter<false>(F, 2, t);
    }
  }
  if (tid == 0) SU8(feasible)[b] = ok;
}

// The lane kernels' prologue: the vocabulary and the type tables, read
// from device memory (each lane runs one type filter at most, so staging
// them per lane would cost more than it saves), the types' key masks from
// the scratch block the cache kernel filled; one working row.
__device__ void lane_prologue() {
  Scratch S;
  carve((char*)A.scratch, A, S);
  stage_vocab();
  stage_tables(0, 1, S.kc.t);
}

// the lane kernels' dynamic shared memory: one working row
#define SWEEP_LANE_SMEM sizeof(WorkRow)

// Upload both argument blocks and launch the cache build (its type tables
// in shared memory); the caller then launches its lane kernel on the same
// stream with SWEEP_LANE_SMEM bytes. Returns a cudaError_t.
inline int sweep_begin(const StepArgs* args, const SweepArgs* sargs, cudaStream_t s) {
  if (sargs->B <= 0 || sargs->C <= 0 || args->T <= 0) return (int)cudaErrorInvalidValue;
  StepArgs a = *args;
  size_t dyn = 0;
  const int code = step_smem((const void*)sweep_cache_kernel, a, 1, &dyn);
  if (code != 0) return code;
  cudaError_t err = cudaMemcpyToSymbolAsync(A, &a, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(SA, sargs, sizeof(SweepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  sweep_cache_kernel<<<1, NT, dyn, s>>>();
  return (int)cudaGetLastError();
}

// The sweep field list as a "ptr,ptr,...|int,int,..." string.
static const char kSweepFieldNames[] =
    KTPU_SWEEP_PTR_FIELDS(KTPU_STR_NAME) "|" KTPU_SWEEP_INT_FIELDS(KTPU_STR_NAME);

// The extern "C" surface every sweep library exports beside its launch.
#define KTPU_SWEEP_EXPORTS(name)                                                                   \
  KTPU_STEP_EXPORTS(name)                                                                          \
  extern "C" const char* name##_sweep_field_names() { return kSweepFieldNames; }                   \
  extern "C" int name##_sweep_args_size() { return (int)sizeof(SweepArgs); }                       \
  extern "C" long long name##_scratch_bytes(const StepArgs* args) {                                \
    Scratch s;                                                                                     \
    return (long long)carve(nullptr, *args, s);                                                    \
  }
