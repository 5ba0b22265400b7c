// The delta-state consolidation sweep core, shared by K6 fast_sweep
// (fast_sweep.cu) and K8 set_sweep (set_sweep.cu).
//
// Replaces karpenter_tpu/controllers/disruption/sweep.py:82
// `_ffd_feasibility_core` (with tpu_runs.py:185 `_build_cache` for the
// representative pod, which the reference's callers run first).
//
// Design. Two launches on one stream, CTAs of NT = 256 threads:
//   1. sweep_cache_kernel, a grid of 1 + ceil(E / NT) CTAs: CTA 0 stages
//      the representative pod (batch row 0 of StepArgs) with the type
//      tables, builds the run cache's template half (run_cache.cuh: the
//      template screen ok_t and the final template rows) and the
//      template-fit table fit1[t, c] (the type filter of template t's
//      final row at its daemon overhead plus one pod of class c); each
//      other CTA takes NT existing nodes: their key masks and the
//      existing-node screen ok_e. Lane-independent, so built once, and the
//      E-wide half no longer waits on one SM. (T is 1 on the fleets the
//      sweeps serve, so the template half stays on one CTA: a split by
//      template would have every CTA derive the types' key masks itself.)
//   2. the caller's lane kernel, <<<B, NT>>>, up to four lanes an SM: CTA
//      b derives its lane into shared memory (the removed slots and the
//      nodes the screen refuses at -1 in its [E, R] availability, its
//      class counts) and runs lane_core: per class, thread t owns nodes
//      [t * chunk, (t + 1) * chunk), the threads' capacities go through a
//      block-wide exclusive scan, and each node takes min(max(count -
//      before, 0), cap) pods in place (the last class takes none: nothing
//      reads the availability after it); then the lane's verdict: all pods
//      placed, or the first leftover class's first workable template hosts
//      the whole leftover total (one type filter over the I types).
// Everything is int32 and exact: the host's int64 guards
// (capacity_cumsum_fits_int32, the worst leftover total < 2^30) prove no
// sum wraps. Node order is thread order, so the scan is the reference's
// cumsum in node order; a class's placed total is min(max(count, 0),
// total capacity), the sum of the per-node takes. A lane's first-index
// choices (c0, tstar) take index 0 when nothing qualifies, as jnp.argmax
// of all-false does. The lane counts of K8, base + M[b] @ P, are partial
// sums over the threads' candidates, reduced by warp shuffles and one
// pass over the warps' partials: int32 addition in any order, no float
// and no atomics.
//
// Bound on an H100: bytes (each lane reads the base availability once).
// A lane's availability lives in shared memory, laid out
// [chunk][R][NT + 1] so a thread's node and the coalesced derivation both
// hit distinct banks; where it does not fit beside the working row (or the
// wrapper's SMB cap is lower) it lives in the device buffer `avail`, same
// layout, which the wrapper then allocates (<kernel>_lane_avail_words).
#pragma once
#include <algorithm>
#define NT 256
#include "step.cuh"
#include "run_cache.cuh"

// The lanes' argument block, declared once (the Python wrapper builds its
// ctypes structure from <kernel>_sweep_field_names()). K6 reads cand_idx
// and counts, K8 slot_cand, member, base_counts and percand; a kernel
// ignores the other's fields.
#define KTPU_SWEEP_PTR_FIELDS(X)                                                             \
  /* [E, R] base availability, [C, R] class requests */                                     \
  X(avail0) X(sizes)                                                                         \
  /* work: [B, avail words] lane availability (null: in shared memory), */                  \
  /* [B, C] leftovers (an output too), [T, C] template fit (u8) */                          \
  X(avail) X(left) X(fit1)                                                                   \
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

// lanes an SM the lane kernels are built for (registers: 64 a thread)
#define SWEEP_LANES_PER_SM 4

// the lane verdict's scalars, set by thread 0
__shared__ int sw_tot[KTPU_MAX_R];
__shared__ int sw_any_left, sw_has_t, sw_tstar;

// ---------------------------------------------------------------------------
// launch 1: the run cache and the template-fit table

// The hostname groups' nonempty flags (step_prologue's, a warp a group).
// All threads; the caller syncs before reading them.
__device__ void stage_hne() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < A.Gh; g += NWARP) {
    bool any = false;
    for (int s = lane; s < A.S && !any; s += 32) any = I32(h_cnt)[(long long)g * A.S + s] > 0;
    any = __any_sync(FULL_MASK, any);
    if (lane == 0) sh.hne[g] = any;
  }
}

// CTA 0's prologue: step_prologue without the claim slots' and existing
// nodes' key masks (the other CTAs take the existing nodes; the sweeps
// screen no claim). All threads.
__device__ void sweep_prologue(const KeyCache& kc) {
  const int tid = threadIdx.x;
  stage_vocab();
  type_keys(kc);
  __syncthreads();
  stage_tables(A.SMB, 1, kc.t);
  for (int t = tid; t < A.T; t += NT) {
    const RowKeys k = row_keys(ROW(treq, t), sh.w2k, A.TW, A.K);
    sh.tkeys[0][t] = k.other;
    sh.tkeys[1][t] = k.notin;
    sh.tkeys[2][t] = k.defined;
    sh.tkeys[3][t] = k.tol;
    sh.tkeys[4][t] = row_bnd(ROW(treq, t));
  }
  stage_hne();
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) sweep_cache_kernel() {
  const int tid = threadIdx.x, R = A.R, C = SA.C;
  Scratch S;
  carve((char*)A.scratch, A, S);
  if (blockIdx.x > 0) {
    // NT existing nodes: key masks, then the screen against the pod
    stage_vocab();
    stage_tables(0, 1, S.kc.t);
    stage_hne();
    __syncthreads();
    stage_pod(0);
    const int e = (blockIdx.x - 1) * NT + tid;
    if (e < A.E) {
      keys_put(S.kc.e, e, row_keys(ROW(ereq, e), sh.w2k, A.TW, A.K), row_bnd(ROW(ereq, e)));
      cache_existing(0, S, e);
    }
    return;
  }
  sweep_prologue(S.kc);
  stage_pod(0);
  for (int t = 0; t < A.T; ++t) cache_template(0, S, t);
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

// A lane's working memory: its availability (shared or device memory) and,
// in shared memory after the working row, its class counts, leftovers,
// the warps' count partials [C, NWARP], the class sizes [C, R] and (K8)
// its membership row [J].
struct LaneMem {
  int* av;
  int *cnt, *left, *part, *sz, *m;
  int chunk;  // nodes a thread
};

__host__ __device__ inline int lane_chunk(int E) { return E > NT ? (E + NT - 1) / NT : 1; }

__host__ __device__ inline long long lane_avail_words(const StepArgs& a) {
  const long long chunk = lane_chunk(a.E);
  return chunk * a.R * (NT + 1);
}

__host__ __device__ inline long long lane_small_bytes(const StepArgs& a, const SweepArgs& s) {
  const long long words = 2ll * s.C + (long long)s.C * NWARP + (long long)s.C * a.R + s.J;
  return (long long)sizeof(WorkRow) + ((4 * words + 15) & ~15ll);
}

__device__ LaneMem lane_mem(int b) {
  const int C = SA.C;
  LaneMem L;
  L.chunk = lane_chunk(A.E);
  int* p = (int*)(dsm + sizeof(WorkRow));
  L.cnt = p;
  L.left = L.cnt + C;
  L.part = L.left + C;
  L.sz = L.part + C * NWARP;
  L.m = L.sz + C * A.R;
  L.av = SA.avail ? SI32(avail) + (long long)b * lane_avail_words(A) : (int*)(dsm + lane_small_bytes(A, SA));
  return L;
}

// node t * chunk + k's dim r in a lane's availability
__device__ __forceinline__ int av_at(int k, int r, int t) { return (k * A.R + r) * (NT + 1) + t; }

// The lane's availability from the base: -1 on a removed node and on one
// the screen refuses (both take no pod), and the class sizes. All threads
// call; `removed(e)` is the lane's removal rule.
template <class Removed>
__device__ void derive_avail(const LaneMem& L, Removed removed) {
  const int tid = threadIdx.x, E = A.E, R = A.R;
  Scratch S;
  carve((char*)A.scratch, A, S);
  // threads over nodes (neighbouring threads read neighbouring rows); each
  // node's loads are issued before its stores, and four nodes at a time
#pragma unroll 4
  for (int e = tid; e < E; e += NT) {
    const int t = e / L.chunk, k = e - t * L.chunk;
    const bool off = !S.ok_e[e] || removed(e);
    const int* src = SI32(avail0) + (long long)e * R;
    for (int r = 0; r < R; ++r) {
      const int v = src[r];
      L.av[av_at(k, r, t)] = off ? -1 : v;
    }
  }
  for (int i = tid; i < SA.C * R; i += NT) L.sz[i] = SI32(sizes)[i];
}

// Pods of one class (requests s) node (k, thread) can take: min over
// requested dims of a[r] / s[r] (INF_I when nothing is requested), 0 on a
// node with a negative dim (removed, refused or overcommitted).
__device__ __forceinline__ int node_cap(const int* av, int k, const int* s) {
  const int t = threadIdx.x;
  int cap = INF_I;
  for (int r = 0; r < A.R; ++r) {
    const int a = av[av_at(k, r, t)];
    if (a < 0) return 0;
    if (s[r] > 0) cap = min(cap, a / s[r]);
  }
  return max(cap, 0);
}

// The class loop and the verdict of lane b over its derived availability
// and class counts L.cnt. All threads call, after the derivation and a
// barrier.
__device__ void lane_core(int b, const LaneMem& L) {
  const int tid = threadIdx.x, E = A.E, R = A.R, C = SA.C;
  const int n = max(min(L.chunk, E - tid * L.chunk), 0);  // this thread's nodes
  for (int c = 0; c < C; ++c) {
    const int* s = L.sz + c * R;
    int mine = 0;
    for (int k = 0; k < n; ++k) mine += node_cap(L.av, k, s);
    int total;
    int before = block_exclusive_scan(mine, &total);
    const int want = L.cnt[c];
    if (c + 1 < C) {
      for (int k = 0; k < n; ++k) {
        const int cap = node_cap(L.av, k, s);
        const int take = min(max(want - before, 0), cap);
        if (take > 0)
          for (int r = 0; r < R; ++r) L.av[av_at(k, r, tid)] -= take * s[r];
        before += cap;
      }
    }
    if (tid == 0) {
      const int left = want - min(max(want, 0), total);
      L.left[c] = left;
      SI32(left)[(long long)b * C + c] = left;
    }
  }
  __syncthreads();
  Scratch S;
  carve((char*)A.scratch, A, S);
  if (tid == 0) {
    int lsum = 0, c0 = -1;
    for (int c = 0; c < C; ++c) {
      lsum += L.left[c];
      if (c0 < 0 && L.left[c] > 0) c0 = c;
    }
    c0 = max(c0, 0);
    for (int r = 0; r < R; ++r) {
      int tot = 0;
      for (int c = 0; c < C; ++c) tot += L.left[c] * L.sz[c * R + r];
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
      // the vocabulary and the type tables, read from device memory (one
      // type filter a lane at most), the types' key masks from the
      // scratch block the cache kernel filled
      stage_vocab();
      stage_tables(0, 1, S.kc.t);
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

// ---------------------------------------------------------------------------
// host side

// The lane kernel's dynamic shared memory (the lane's availability in it
// when it fits the card's room and the wrapper's SMB cap), and its
// attribute set; *on_chip says where the availability lives. Returns a
// cudaError_t.
inline int sweep_lane_smem(const void* kernel, const StepArgs& a, const SweepArgs& s, size_t* bytes, bool* on_chip) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const long long room = std::min((long long)optin - (long long)fa.sharedSizeBytes, (long long)a.SMB);
  const long long small = lane_small_bytes(a, s), full = small + 4 * lane_avail_words(a);
  *on_chip = full <= room;
  *bytes = (size_t)(*on_chip ? full : small);
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// Upload both argument blocks and launch the cache build (its type tables
// in shared memory); the caller then launches its lane kernel on the same
// stream with *lane_bytes of dynamic shared memory. Returns a cudaError_t.
inline int sweep_begin(const void* lanes_kernel, const StepArgs* args, const SweepArgs* sargs, cudaStream_t s,
                       size_t* lane_bytes) {
  if (sargs->B <= 0 || sargs->C <= 0 || args->T <= 0) return (int)cudaErrorInvalidValue;
  StepArgs a = *args;
  SweepArgs sa = *sargs;
  bool on_chip = false;
  int code = sweep_lane_smem(lanes_kernel, a, sa, lane_bytes, &on_chip);
  if (code != 0) return code;
  if (on_chip)
    sa.avail = nullptr;
  else if (sa.avail == nullptr)
    return (int)cudaErrorInvalidValue;  // the wrapper owes the device buffer
  size_t dyn = 0;
  code = step_smem((const void*)sweep_cache_kernel, a, 1, &dyn);
  if (code != 0) return code;
  cudaError_t err = cudaMemcpyToSymbolAsync(A, &a, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(SA, &sa, sizeof(SweepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  sweep_cache_kernel<<<1 + (a.E + NT - 1) / NT, NT, dyn, s>>>();
  return (int)cudaGetLastError();
}

// The sweep field list as a "ptr,ptr,...|int,int,..." string.
static const char kSweepFieldNames[] =
    KTPU_SWEEP_PTR_FIELDS(KTPU_STR_NAME) "|" KTPU_SWEEP_INT_FIELDS(KTPU_STR_NAME);

// The extern "C" surface every sweep library exports beside its launch:
// the field names, the block's size, the scratch block's bytes and the
// device-memory words a lane's availability needs (0 when it lives in
// shared memory; the wrapper allocates B of them).
#define KTPU_SWEEP_EXPORTS(name, lanes_kernel)                                                     \
  KTPU_STEP_EXPORTS(name)                                                                          \
  extern "C" const char* name##_sweep_field_names() { return kSweepFieldNames; }                   \
  extern "C" int name##_sweep_args_size() { return (int)sizeof(SweepArgs); }                       \
  extern "C" long long name##_scratch_bytes(const StepArgs* args) {                                \
    Scratch s;                                                                                     \
    return (long long)carve(nullptr, *args, s);                                                    \
  }                                                                                                \
  extern "C" long long name##_lane_avail_words(const StepArgs* args, const SweepArgs* sargs) {     \
    size_t bytes = 0;                                                                              \
    bool on_chip = false;                                                                          \
    if (sweep_lane_smem((const void*)lanes_kernel, *args, *sargs, &bytes, &on_chip) != 0) return -1; \
    return on_chip ? 0 : lane_avail_words(*args);                                                  \
  }
