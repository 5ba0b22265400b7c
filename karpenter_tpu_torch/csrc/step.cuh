// The exact per-pod FFD step as device code, shared by K2 scan_step
// (scan_step.cu), K3 run_step (run_step.cu) and K7 scan_lanes
// (scan_lanes.cu); the sweeps' K6 and K8 (sweep_core.cuh) reuse its working
// row and type filter.
//
// Replaces karpenter_tpu/solver/tpu_kernel.py:560 `_step` (with
// `_eval_topology`, `_apply_tighten`, `_topo_nonempty_ok`, `_type_filter`,
// `_min_values_ok`, the rank updates, `_eval_filters` and `_record`), and
// the relax tier loop: :872 `_x_at_tier`, :898 `_step_relax` and :107
// `odo_tier_tick` (`relax_step` and `tier_tick` below).
//
// Design. One CTA of NT threads takes one pod at a time (a dependent
// chain: the next pod sees this pod's commit). `stage_pod` puts the pod row
// and its per-constraint scalars in shared memory; `exact_step` then runs,
// with barriers between:
//   1. the existing-node screen, threads over E, then a first-index argmin;
//   2. the claim screen, threads over N (cheap gates first, then compat,
//      topology, the tighten nonempty check);
//   3. the exact verify loop in rank order: a block argmin over the live
//      candidates' (rank, index), the final row built in a working row, the
//      type filter with threads over I (offerings folded with shared-memory
//      atomicOr, the word packed with __ballot_sync), minValues, exclude and
//      repeat;
//   4. the template branch when nothing was found, templates in order;
//   5. the commit: claim rows, alive words, cmax_alloc, ranks, pool limits,
//      reservations, topology counts (`record_row`) and host ports.
// A pod with a preference ladder goes through `relax_step`: each tier
// restages the tier's rows (`stage_rows`) and runs the same exact step,
// until a tier places the pod or overflows the claim slots. A failed tier
// commits nothing (every global write of exact_step sits behind
// kind != KIND_FAIL; the claim screen's `cand` scratch is rewritten in full
// by each tier), so every tier sees the state before the pod, as the
// reference's loop calling `_step` on the outer state does.
//
// What bounds it on an H100. The step is a chain of dependent loads and
// barriers on one SM: its time is latency, not bytes (PERF.md §5 has the
// per-phase clock breakdown, `prof_mark` below). The design keeps the
// chain short three ways:
//   - Launch-invariant tables in shared memory, staged once per launch
//     (`stage_tables`): the zone-family groups' value words, bits and
//     registrations [Gv, VMAX] (every topology screen reads them), each
//     instance type's key masks (other, defined, tol; 24 B a type, derived
//     in the prologue with row_keys, threads over I, into the scratch
//     block's key cache: `type_keys`), the offerings grouped by their
//     three word/bit probes (a class per distinct zone, capacity type and
//     reservation: its packed probes and the words of the types offered that way; the
//     fold per working row is one OR per class and type word instead of an
//     atomic per offering), its allocatable [R, I], the bounds of the keys
//     some type bounds, and the types' mask words word-major [TW, I]
//     (thread i's loads of word w fall in consecutive banks). They go in
//     that order into the dynamic shared memory beside the working rows
//     while they fit the budget the launch function sets (the opt-in
//     maximum less the static block, or the wrapper's cap where smaller;
//     `tab_layout`). The wrapper derives the other tables once per Tables
//     (tpu_kernel.py `launch_type_tables`). At the headline (I=512,
//     O=4096 in 8 classes, TW=36, R=4, no bounded type keys) the tables
//     take about 94 KB and K3's whole block about 160 KB of the 227 KB; a
//     table that does not fit is read from its device copy, same layout,
//     through the same pointer. So the type filter reads device memory only
//     for the alive words of the claim (or template) it checks. A key's
//     words are walked only while it can still conflict (`kw0`/`kw1`, the
//     key's word range), stopping at the first word both rows allow.
//   - Key masks cached per claim slot and existing node (`KeyCache` in the
//     scratch block), filled in the prologue from the state as handed in
//     and rewritten wherever a row is committed; the screens skip every word
//     and bound of a key the two rows do not both define or both tolerate
//     (`pod_conflict`), so a claim whose keys cannot conflict costs a few
//     loads; the cache also keeps the keys each row bounds, so a row that
//     bounds none (most claims) costs no bound loads.
//   - No single-thread section over TW, K or C: a working row's prologue
//     (conflict, compat, collapse, topology) and epilogue run on one warp
//     with __reduce_or_sync and shuffles, as do the pod's key masks.
// Working rows (`WorkRow`, in dynamic shared memory) are templated on a
// team (`Team<false>` the CTA, `Team<true>` one warp), so K3 builds a bulk
// window's rows on its 16 warps at once (run_step.cu). The hostname groups'
// nonempty flags are kept current in shared memory (counts only grow inside
// a launch) rather than rescanned over S slots for every pod.
// All state lives in device memory and is updated in place. Every decision
// is int32 or bit arithmetic; no float touches a decision. Ties break to
// the lowest index, as jnp.argmin/argmax do. Scatters the reference leaves
// to XLA's drop-out-of-bounds rule are guarded, and its clamped gathers are
// clamped here.
//
// Each library that includes this header (one source each) gets its own
// argument block `A` in constant memory and shared block `sh`.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "algebra.cuh"
#include "step_args.h"

using namespace ktpu;

#ifndef NT
#define NT 512  // threads a CTA (the sweep libraries take 256, sweep_core.cuh)
#endif
#define NWARP (NT / 32)
#define INF_I (1 << 30)
#define FULL_MASK 0xffffffffu

enum {
  TOPO_NONE = 0,
  TOPO_SPREAD_V = 1,
  TOPO_AFFINITY_V = 2,
  TOPO_ANTI_V = 3,
  TOPO_SPREAD_H = 4,
  TOPO_AFFINITY_H = 5,
  TOPO_ANTI_H = 6
};
enum { KIND_EXISTING = 0, KIND_CLAIM = 1, KIND_NEW = 2, KIND_FAIL = 3 };

__constant__ StepArgs A;

#ifdef KTPU_LANE_GRID
// K7 scan_lanes: one CTA per lane. The host resolves each lane's pointer to
// every field of KTPU_LANE_PTR_FIELDS (its state, pod rows, outputs and
// scratch) and uploads them, one row of KTPU_NLANE pointers a lane, into
// the constant table LP beside A; CTA b reads field f at LP[b][LF_f], a
// constant-cache load at a block-uniform address. Every other pointer
// field (the tables all lanes share) is read from A, as K2 and K3 read it:
// `lane_field` sorts the fields at compile time, so a table access costs
// what it costs in K2. A launch of more than KTPU_MAX_LANES lanes runs as
// consecutive launches of KTPU_MAX_LANES. The library without the define
// (K2, K3) reads A as it is.
#define KTPU_LANE_ENUM(name) LF_##name,
enum { KTPU_LANE_PTR_FIELDS(KTPU_LANE_ENUM) KTPU_NLANE };
#undef KTPU_LANE_ENUM
#define KTPU_MAX_LANES 128
__constant__ void* LP[KTPU_MAX_LANES][KTPU_NLANE];
static_assert(sizeof(LP) + sizeof(StepArgs) <= 64 * 1024, "the lane table and A outgrow constant memory");

// field f's row in LP, or -1 for a field all lanes share
__host__ __device__ constexpr int lane_field(size_t off) {
#define KTPU_LANE_CASE(name) \
  if (off == offsetof(StepArgs, name)) return LF_##name;
  KTPU_LANE_PTR_FIELDS(KTPU_LANE_CASE)
#undef KTPU_LANE_CASE
  return -1;
}

template <int L>
__device__ __forceinline__ void* field_ptr(void* shared) {
  if constexpr (L < 0)
    return shared;
  else
    return LP[blockIdx.x][L];
}
#define FIELD(f) field_ptr<lane_field(offsetof(StepArgs, f))>(A.f)
#else
#define FIELD(f) (A.f)
#endif
#define I32(f) ((int*)FIELD(f))
#define U8(f) ((uint8_t*)FIELD(f))
#define ROW(p, r)                                                                              \
  Row {                                                                                        \
    I32(p##_mask) + (long long)(r)*A.TW, I32(p##_exmask) + (long long)(r)*A.TW,                \
        U8(p##_other) + (long long)(r)*A.K, U8(p##_notin) + (long long)(r)*A.K,                \
        U8(p##_defined) + (long long)(r)*A.K, I32(p##_gt) + (long long)(r)*A.K,                \
        I32(p##_lt) + (long long)(r)*A.K, I32(p##_minv) + (long long)(r)*A.K                   \
  }

struct TopoOut {  // per-constraint choices of one candidate
  int first[KTPU_MAX_C];   // spread: chosen domain
  int bfirst[KTPU_MAX_C];  // affinity bootstrap: chosen domain
  int flags[KTPU_MAX_C];   // 1 spread viable, 2 affinity direct, 4 bootstrap ok
};

// One candidate's final (merged + tightened) row and its type filter, in
// dynamic shared memory: row 0 is the CTA's, rows 1..NWARP the warps' (K3's
// bulk windows).
struct WorkRow {
  int fmask[KTPU_MAX_TW], fex[KTPU_MAX_TW];
  int fgt[KTPU_MAX_K], flt[KTPU_MAX_K], fminv[KTPU_MAX_K];
  RowKeys fk;
  u64 fcollapse, fother_m, ftouched, fsegm;
  u64 fbound0;  // keys no type bounds whose own bounds leave a value (fgt < flt)
  u64 fbnd;     // keys the row bounds (gt or lt off its sentinel)
  int fhasminv, row_compat, row_viable;
  TopoOut tout;
  unsigned fi[KTPU_MAX_IW];      // surviving types
  unsigned offany[KTPU_MAX_IW];  // types with a matching offering
  int total[KTPU_MAX_R];         // the request total the types must hold
  int red[KTPU_MAX_R];           // surviving_max's column max
};

struct Shared {
  int w2k[KTPU_MAX_TW];
  int full[KTPU_MAX_TW];
  u64 well_known;
  // the launch's type tables: shared-memory copies or the device copies
  const int* t_vword;     // [Gv, VMAX] the zone-family groups' value words
  const int* t_vbit;      // [Gv, VMAX] and bits
  const uint8_t* t_vreg;  // [Gv, VMAX] registered domains
  const u64* t_keys;   // [3, I] other, defined, tol
  const int* t_ocls;   // [NOC, 2] an offering class's packed probes
  const int* t_otyp;   // [NOC, IW] and the types it offers
  const int* t_alloc;  // [R, I]
  const int* t_bgt;    // [NBK, I]
  const int* t_blt;    // [NBK, I]
  const int* t_mask;   // [TW, I]
  int bkey[KTPU_MAX_K];
  int bkidx[KTPU_MAX_K];     // key k's row in t_bgt/t_blt, -1 when no type bounds it
  u64 bkmask;                // keys some type bounds
  int kw0[KTPU_MAX_K], kw1[KTPU_MAX_K];  // key k's words lie in [kw0, kw1)
  u64 tkeys[5][KTPU_MAX_T];  // the templates' key masks (KeyRows order)
  uint8_t hne[KTPU_MAX_G];   // hostname group g has a nonzero count now
  // the pod
  int pmask[KTPU_MAX_TW], pex[KTPU_MAX_TW];
  int pgt[KTPU_MAX_K], plt[KTPU_MAX_K], pminv[KTPU_MAX_K];
  RowKeys pk;
  u64 pcollapse;  // keys whose pod bounds alone leave no value (pgt >= plt)
  int any_v;      // the staged rows carry a zone-family constraint
  int preq[KTPU_MAX_R];
  int typeok[KTPU_MAX_IW];
  int hp_own[KTPU_MAX_HPW], hp_conf[KTPU_MAX_HPW];
  uint8_t sel_v[KTPU_MAX_G], sel_h[KTPU_MAX_G], inv_h[KTPU_MAX_G], own_h[KTPU_MAX_G], ne_h[KTPU_MAX_G];
  int ckind[KTPU_MAX_C], cgid[KTPU_MAX_C], csel[KTPU_MAX_C], cgv[KTPU_MAX_C], ckid[KTPU_MAX_C];
  int cskew[KTPU_MAX_C], cmin[KTPU_MAX_C], cboot[KTPU_MAX_C];
  const uint8_t* ptol_t;  // [T] the staged rows' template tolerations
  const uint8_t* ptol_e;  // [E] and existing-node tolerations
  int valid, n_claims;
  unsigned uni[KTPU_MAX_TW];  // minValues union
  unsigned cand_r[KTPU_MAX_NRESW];
  int rk[NWARP], ri[NWARP];
  int best_key, best_idx;
  int rank_j, count_j;
  int bw[NWARP];  // block_reduce partials
  // the run kernel (run_step.cu): a second fill level, hostname budgets
  // per constraint, the bulk case's scalars and its window targets
  unsigned fi2[KTPU_MAX_IW];
  int red2[KTPU_MAX_R];
  int hdyn[KTPU_MAX_C], hcap0[KTPU_MAX_C], hgid[KTPU_MAX_C];
  int r_case, r_k, r_t, r_hbf, nseq, lcount;
  int wtgt[KTPU_RUN_W], worder[KTPU_RUN_W], wok[KTPU_RUN_W];
  // the per-phase clock breakdown (thread 0)
  long long prof_cyc[KTPU_NPH];
  int prof_cnt[KTPU_NPH];
  long long prof_t, prof_t0, prof_g0;
};

__shared__ Shared sh;
extern __shared__ __align__(16) unsigned char dsm[];

__device__ __forceinline__ WorkRow& wrow(int j) { return ((WorkRow*)dsm)[j]; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

__device__ __forceinline__ bool is_v(int kind) { return kind >= TOPO_SPREAD_V && kind <= TOPO_ANTI_V; }

__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(FULL_MASK, (unsigned)x);
  const unsigned hi = __reduce_or_sync(FULL_MASK, (unsigned)(x >> 32));
  return ((u64)hi << 32) | lo;
}

// The threads that share one working row: the CTA or one warp.
template <bool WARP>
struct Team;
template <>
struct Team<false> {
  static constexpr int size = NT;
  __device__ static __forceinline__ int rank() { return threadIdx.x; }
  __device__ static __forceinline__ void sync() { __syncthreads(); }
  __device__ static __forceinline__ bool any(bool p) { return __syncthreads_or(p); }
};
template <>
struct Team<true> {
  static constexpr int size = 32;
  __device__ static __forceinline__ int rank() { return threadIdx.x & 31; }
  __device__ static __forceinline__ void sync() { __syncwarp(); }
  // a barrier too: the lanes' shared-memory writes before it are visible after
  __device__ static __forceinline__ bool any(bool p) {
    __syncwarp();
    return __any_sync(FULL_MASK, p);
  }
};

// ---------------------------------------------------------------------------
// the per-phase clock breakdown (A.prof set; K7 profiles only a one-lane
// launch): thread 0 reads clock64() after the barrier that ends a phase and
// charges the cycles since the previous mark to it. No decision reads it.

__device__ __forceinline__ bool prof_on() { return A.prof != nullptr; }

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void prof_mark(int ph) {
  if (prof_on() && threadIdx.x == 0) {
    const long long now = clock64();
    sh.prof_cyc[ph] += now - sh.prof_t;
    sh.prof_cnt[ph] += 1;
    sh.prof_t = now;
  }
}

// a phase that ends without a barrier of its own gets one while profiling
__device__ __forceinline__ void prof_sync(int ph) {
  if (prof_on()) {
    __syncthreads();
    prof_mark(ph);
  }
}

// thread 0, before the launch's first barrier
__device__ void prof_begin() {
  if (prof_on() && threadIdx.x == 0) {
    for (int i = 0; i < KTPU_NPH; ++i) {
      sh.prof_cyc[i] = 0;
      sh.prof_cnt[i] = 0;
    }
    sh.prof_g0 = globaltimer();
    sh.prof_t0 = sh.prof_t = clock64();
  }
}

// thread 0 writes the breakdown: cycles, entries, total cycles, total ns
__device__ void prof_end() {
  if (prof_on() && threadIdx.x == 0) {
    long long* out = (long long*)A.prof;
    for (int i = 0; i < KTPU_NPH; ++i) {
      out[i] = sh.prof_cyc[i];
      out[KTPU_NPH + i] = sh.prof_cnt[i];
    }
    out[2 * KTPU_NPH] = clock64() - sh.prof_t0;
    out[2 * KTPU_NPH + 1] = globaltimer() - sh.prof_g0;
  }
}

// ---------------------------------------------------------------------------
// the launch's type tables in dynamic shared memory

// Offsets of the tables in dynamic shared memory after `nrows` working rows
// (-1: the table stays in device memory), and the launch's dynamic bytes.
// Tables go in order while they fit `budget`; host and device compute the
// same layout from the same arguments.
struct TabLayout {
  long long topo, keys, off, alloc, bounds, mask, bytes;
};

__host__ __device__ inline long long tab_place(long long& off, long long size, long long budget) {
  if (off + size > budget) return -1;
  const long long at = off;
  off = (off + size + 15) & ~15ll;
  return at;
}

__host__ __device__ inline TabLayout tab_layout(const StepArgs& a, int nrows, long long budget) {
  TabLayout L;
  long long off = (long long)nrows * (long long)sizeof(WorkRow);
  const long long I = a.I, GV = (long long)a.Gv * a.VMAX;
  L.topo = tab_place(off, 9 * GV, budget);
  L.keys = tab_place(off, 3 * 8 * I, budget);
  L.off = tab_place(off, (8 + 4 * (long long)a.IW) * a.NOC, budget);
  L.alloc = tab_place(off, 4 * (long long)a.R * I, budget);
  L.bounds = tab_place(off, 2 * 4 * (long long)a.NBK * I, budget);
  L.mask = tab_place(off, 4 * (long long)a.TW * I, budget);
  L.bytes = off;
  return L;
}

__device__ const void* stage_table(long long at, const void* src, long long bytes) {
  if (at < 0) return src;
  int* dst = (int*)(dsm + at);
  const int* s = (const int*)src;
  for (long long i = threadIdx.x; i < bytes / 4; i += NT) dst[i] = s[i];
  return dst;
}

// All threads, in the prologue: copy the tables that fit `budget` beside
// the `nrows` working rows and point sh.t_* at them. `ikeys` is the types'
// key masks in the scratch block (`type_keys`).
__device__ void stage_tables(long long budget, int nrows, const u64* ikeys) {
  const TabLayout L = tab_layout(A, nrows, budget);
  const long long I = A.I, nb = 4 * (long long)A.NBK * I, GV = (long long)A.Gv * A.VMAX;
  const void* vword = stage_table(L.topo, A.v_word, 4 * GV);
  const void* vbit = stage_table(L.topo < 0 ? -1 : L.topo + 4 * GV, A.v_bit, 4 * GV);
  const void* vreg = A.v_reg;
  if (L.topo >= 0) {
    uint8_t* dst = dsm + L.topo + 8 * GV;
    for (long long i = threadIdx.x; i < GV; i += NT) dst[i] = ((const uint8_t*)A.v_reg)[i];
    vreg = dst;
  }
  const void* keys = stage_table(L.keys, ikeys, 3 * 8 * I);
  const void* ocls = stage_table(L.off, A.oclass, 8 * (long long)A.NOC);
  const void* otyp = stage_table(L.off < 0 ? -1 : L.off + 8 * (long long)A.NOC, A.otypes, 4 * (long long)A.IW * A.NOC);
  const void* alloc = stage_table(L.alloc, A.ialloc_t, 4 * (long long)A.R * I);
  const void* bgt = stage_table(L.bounds, A.igt_t, nb);
  const void* blt = stage_table(L.bounds < 0 ? -1 : L.bounds + nb, A.ilt_t, nb);
  const void* mask = stage_table(L.mask, A.imask_t, 4 * (long long)A.TW * I);
  if (threadIdx.x == 0) {
    sh.t_vword = (const int*)vword;
    sh.t_vbit = (const int*)vbit;
    sh.t_vreg = (const uint8_t*)vreg;
    sh.t_keys = (const u64*)keys;
    sh.t_ocls = (const int*)ocls;
    sh.t_otyp = (const int*)otyp;
    sh.t_alloc = (const int*)alloc;
    sh.t_bgt = (const int*)bgt;
    sh.t_blt = (const int*)blt;
    sh.t_mask = (const int*)mask;
    u64 bm = 0;
    for (int k = 0; k < A.K; ++k) sh.bkidx[k] = -1;
    for (int j = 0; j < A.NBK; ++j) {
      const int k = ((const int*)A.bkeys)[j];
      sh.bkey[j] = k;
      sh.bkidx[k] = j;
      bm |= kbit(k);
    }
    sh.bkmask = bm;
  }
  __syncthreads();
}

// the table layout of the library's last launch (for the wrapper's report)
inline TabLayout& last_layout() {
  static TabLayout last{-1, -1, -1, -1, -1, -1, 0};
  return last;
}

// Set the type tables' shared-memory budget into `a` (the opt-in maximum
// less the kernel's static block, or the wrapper's a.SMB where that is
// smaller: 0 reads every table from device memory) and the kernel's
// dynamic-memory limit to what the launch needs, in `bytes`. Returns a
// cudaError_t.
inline int step_smem(const void* kernel, StepArgs& a, int nrows, size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const int room = optin - (int)fa.sharedSizeBytes;
  if (a.SMB > room) a.SMB = room;
  const TabLayout L = tab_layout(a, nrows, a.SMB);
  last_layout() = L;
  *bytes = (size_t)L.bytes;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
}

// ---------------------------------------------------------------------------
// key masks cached per row in the scratch block: [5, n] other, notin,
// defined, tol (RowKeys order) and the keys the row bounds (`row_bnd`): a
// key it does not bound keeps the sentinels, so its bounds against another
// row are that row's alone

struct KeyRows {
  u64* k;
  int n;
};

__device__ __forceinline__ RowKeys keys_at(const KeyRows& c, int i) {
  return RowKeys{c.k[i], c.k[c.n + i], c.k[2 * c.n + i], c.k[3 * c.n + i]};
}

__device__ __forceinline__ u64 bnd_at(const KeyRows& c, int i) { return c.k[4 * c.n + i]; }

__device__ __forceinline__ void keys_put(const KeyRows& c, int i, const RowKeys& v, u64 bnd) {
  c.k[i] = v.other;
  c.k[c.n + i] = v.notin;
  c.k[2 * c.n + i] = v.defined;
  c.k[3 * c.n + i] = v.tol;
  c.k[4 * c.n + i] = bnd;
}

__device__ __forceinline__ RowKeys tmpl_keys(int t) {
  return RowKeys{sh.tkeys[0][t], sh.tkeys[1][t], sh.tkeys[2][t], sh.tkeys[3][t]};
}

// the keys row r bounds: gt or lt off its sentinel
__device__ __forceinline__ u64 row_bnd(const Row& r) {
  u64 m = 0;
  for (int k = 0; k < A.K; ++k)
    if (r.gt[k] != INT_MIN || r.lt[k] != INT_MAX) m |= kbit(k);
  return m;
}

// The claim slots', existing nodes' and instance types' key masks: the scan
// kernels' whole scratch block, the head of the run kernel's.
struct KeyCache {
  KeyRows c;  // [5, N]
  KeyRows e;  // [5, E]
  u64* t;     // [3, I] each type's other, defined, tol (the t_keys table's device copy)
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

__host__ __device__ inline KeyRows carve_keys(Carver& c, int n) { return KeyRows{(u64*)c.take((size_t)5 * 8 * n), n}; }

__host__ __device__ inline size_t carve_key_cache(Carver& c, const StepArgs& a, KeyCache& kc) {
  kc.c = carve_keys(c, a.N);
  kc.e = carve_keys(c, a.E);
  kc.t = (u64*)c.take((size_t)3 * 8 * a.I);
  return c.off;
}

// this CTA's scratch block (K7: its lane's)
__device__ __forceinline__ char* scratch_base() { return (char*)U8(scratch); }

// ---------------------------------------------------------------------------
// the block argmin and reductions

// Block-wide argmin over (key, idx), ties to the lower idx; all threads
// call it. Result in sh.best_key/best_idx (INT_MAX when nothing offered).
__device__ void block_argmin(int key, int idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    int k2 = __shfl_down_sync(FULL_MASK, key, off);
    int i2 = __shfl_down_sync(FULL_MASK, idx, off);
    if (k2 < key || (k2 == key && i2 < idx)) {
      key = k2;
      idx = i2;
    }
  }
  if (lane == 0) {
    sh.rk[warp] = key;
    sh.ri[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bk = INT_MAX, bi = INT_MAX;
    for (int w = 0; w < NWARP; ++w)
      if (sh.rk[w] < bk || (sh.rk[w] == bk && sh.ri[w] < bi)) {
        bk = sh.rk[w];
        bi = sh.ri[w];
      }
    sh.best_key = bk;
    sh.best_idx = bi;
  }
  __syncthreads();
}

// warp-wide argmin over (key, idx), ties to the lower idx; every lane gets it
__device__ __forceinline__ void warp_argmin(int& key, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const int k2 = __shfl_xor_sync(FULL_MASK, key, off);
    const int i2 = __shfl_xor_sync(FULL_MASK, idx, off);
    if (k2 < key || (k2 == key && i2 < idx)) {
      key = k2;
      idx = i2;
    }
  }
}

// Block-wide sum / min / max of one int per thread; all threads call and
// all get the result.
enum { RED_SUM = 0, RED_MIN = 1, RED_MAX = 2 };

__device__ __forceinline__ int red_op(int a, int b, int op) {
  return op == RED_SUM ? a + b : (op == RED_MIN ? min(a, b) : max(a, b));
}

__device__ int block_reduce(int v, int op) {
  for (int off = 16; off > 0; off >>= 1) v = red_op(v, __shfl_xor_sync(FULL_MASK, v, off), op);
  if ((threadIdx.x & 31) == 0) sh.bw[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = sh.bw[0];
  for (int w = 1; w < NWARP; ++w) r = red_op(r, sh.bw[w], op);
  __syncthreads();  // sh.bw is free again
  return r;
}

// ---------------------------------------------------------------------------
// topology (tpu_kernel.py _eval_topology)

__device__ __forceinline__ int hcnt(int g, int col) {
  return col < 0 ? 0 : I32(h_cnt)[(long long)g * A.S + col];
}

// bit v of group gv in the merged row (candidate a ∧ pod, bounds folded)
__device__ __forceinline__ bool node_bit(const int* amask, u64 collapse, int gv, int v) {
  const long long o = (long long)gv * A.VMAX + v;
  const int w = sh.t_vword[o];
  if (w < 0) return false;
  if ((collapse >> sh.w2k[w]) & 1) return false;
  const unsigned m = (unsigned)(amask[w] & sh.pmask[w]);
  return (m >> sh.t_vbit[o]) & 1u;
}

__device__ __forceinline__ bool pod_bit(int gv, int v) {
  const long long o = (long long)gv * A.VMAX + v;
  const int w = sh.t_vword[o];
  if (w < 0) return false;
  return ((unsigned)sh.pmask[w] >> sh.t_vbit[o]) & 1u;
}

// One candidate by one thread (the screens).
__device__ bool topo_eval(const int* amask, u64 collapse, int col, u64& touched, TopoOut& t) {
  bool viable = true;
  for (int g = 0; g < A.Gh; ++g)
    if (sh.inv_h[g] && hcnt(g, col) > 0) viable = false;
  touched = 0;
  for (int c = 0; c < A.C; ++c) {
    const int kind = sh.ckind[c], gv = sh.cgv[c], sel = sh.csel[c];
    const long long base = (long long)gv * A.VMAX;
    int first = 0, bfirst = 0, flags = 0;
    bool cv;
    if (kind == TOPO_NONE) {
      cv = true;
    } else if (kind == TOPO_SPREAD_V) {
      bool any = false;
      int best = INF_I;
      for (int v = 0; v < A.VMAX; ++v) {
        if (!sh.t_vreg[base + v] || !node_bit(amask, collapse, gv, v)) continue;
        const int eff = I32(v_cnt)[base + v] + sel;
        if (eff - sh.cmin[c] <= sh.cskew[c]) {
          if (!any || eff < best) {
            best = eff;
            first = v;
          }
          any = true;
        }
      }
      cv = any;
      flags = any ? 1 : 0;
      if (!any) first = 0;
    } else if (kind == TOPO_AFFINITY_V) {
      bool direct = false, bany = false;
      for (int v = 0; v < A.VMAX; ++v) {
        if (!sh.t_vreg[base + v] || !pod_bit(gv, v) || !node_bit(amask, collapse, gv, v)) continue;
        if (I32(v_cnt)[base + v] > 0) direct = true;
        if (!bany) {
          bany = true;
          bfirst = v;
        }
      }
      const bool bok = bany && sh.cboot[c];
      cv = direct || bok;
      flags = (direct ? 2 : 0) | (bok ? 4 : 0);
    } else if (kind == TOPO_ANTI_V) {
      bool any = false;
      for (int v = 0; v < A.VMAX && !any; ++v)
        any = sh.t_vreg[base + v] && I32(v_cnt)[base + v] == 0 && pod_bit(gv, v) &&
              node_bit(amask, collapse, gv, v);
      cv = any;
    } else {
      const int gi = clampi(sh.cgid[c], 0, A.Gh - 1);
      const int gh = hcnt(gi, col);
      if (kind == TOPO_SPREAD_H)
        cv = gh + sel <= I32(h_skew)[clampi(sh.cgid[c], 0, A.GhS - 1)];
      else if (kind == TOPO_AFFINITY_H)
        cv = gh > 0 || (sel > 0 && !sh.ne_h[gi]);
      else
        cv = gh == 0;
    }
    viable = viable && cv;
    if (is_v(kind) && sh.ckid[c] >= 0 && sh.ckid[c] < A.K) touched |= kbit(sh.ckid[c]);
    t.first[c] = first;
    t.bfirst[c] = bfirst;
    t.flags[c] = flags;
  }
  return viable;
}

// The same by the 32 lanes of one warp, lanes over the domains; every lane
// gets the result, lane 0 writes `t`.
__device__ bool topo_eval_warp(const int* amask, u64 collapse, int col, u64& touched, TopoOut& t) {
  const int lane = threadIdx.x & 31;
  bool inv = false;
  for (int g = lane; g < A.Gh; g += 32)
    if (sh.inv_h[g] && hcnt(g, col) > 0) inv = true;
  bool viable = !__any_sync(FULL_MASK, inv);
  touched = 0;
  for (int c = 0; c < A.C; ++c) {
    const int kind = sh.ckind[c], gv = sh.cgv[c], sel = sh.csel[c];
    const long long base = (long long)gv * A.VMAX;
    int first = 0, bfirst = 0, flags = 0;
    bool cv;
    if (kind == TOPO_NONE) {
      cv = true;
    } else if (kind == TOPO_SPREAD_V) {
      // the smallest (eff, v) among the qualifying domains
      int be = INT_MAX, bv = INT_MAX;
      for (int v = lane; v < A.VMAX; v += 32) {
        if (!sh.t_vreg[base + v] || !node_bit(amask, collapse, gv, v)) continue;
        const int eff = I32(v_cnt)[base + v] + sel;
        if (eff - sh.cmin[c] <= sh.cskew[c] && (eff < be || (eff == be && v < bv))) {
          be = eff;
          bv = v;
        }
      }
      warp_argmin(be, bv);
      const bool any = bv != INT_MAX;
      cv = any;
      flags = any ? 1 : 0;
      first = any ? bv : 0;
    } else if (kind == TOPO_AFFINITY_V) {
      bool direct = false;
      int bmin = INT_MAX;
      for (int v = lane; v < A.VMAX; v += 32) {
        if (!sh.t_vreg[base + v] || !pod_bit(gv, v) || !node_bit(amask, collapse, gv, v)) continue;
        if (I32(v_cnt)[base + v] > 0) direct = true;
        bmin = min(bmin, v);
      }
      direct = __any_sync(FULL_MASK, direct);
      bmin = __reduce_min_sync(FULL_MASK, bmin);
      const bool bany = bmin != INT_MAX;
      bfirst = bany ? bmin : 0;
      const bool bok = bany && sh.cboot[c];
      cv = direct || bok;
      flags = (direct ? 2 : 0) | (bok ? 4 : 0);
    } else if (kind == TOPO_ANTI_V) {
      bool any = false;
      for (int v = lane; v < A.VMAX && !any; v += 32)
        any = sh.t_vreg[base + v] && I32(v_cnt)[base + v] == 0 && pod_bit(gv, v) &&
              node_bit(amask, collapse, gv, v);
      cv = __any_sync(FULL_MASK, any);
    } else {
      const int gi = clampi(sh.cgid[c], 0, A.Gh - 1);
      const int gh = hcnt(gi, col);
      if (kind == TOPO_SPREAD_H)
        cv = gh + sel <= I32(h_skew)[clampi(sh.cgid[c], 0, A.GhS - 1)];
      else if (kind == TOPO_AFFINITY_H)
        cv = gh > 0 || (sel > 0 && !sh.ne_h[gi]);
      else
        cv = gh == 0;
    }
    viable = viable && cv;
    if (is_v(kind) && sh.ckid[c] >= 0 && sh.ckid[c] < A.K) touched |= kbit(sh.ckid[c]);
    if (lane == 0) {
      t.first[c] = first;
      t.bfirst[c] = bfirst;
      t.flags[c] = flags;
    }
  }
  return viable;
}

// bit v of constraint c's chosen domain set for this candidate
__device__ __forceinline__ bool cbit(int c, int v, const int* amask, u64 collapse, const TopoOut& t) {
  const int kind = sh.ckind[c], gv = sh.cgv[c];
  const long long o = (long long)gv * A.VMAX + v;
  if (kind == TOPO_SPREAD_V) return (t.flags[c] & 1) && v == t.first[c];
  if (kind == TOPO_AFFINITY_V) {
    if (t.flags[c] & 2)
      return sh.t_vreg[o] && I32(v_cnt)[o] > 0 && pod_bit(gv, v) && node_bit(amask, collapse, gv, v);
    return (t.flags[c] & 4) && v == t.bfirst[c];
  }
  return sh.t_vreg[o] && I32(v_cnt)[o] == 0 && pod_bit(gv, v) && node_bit(amask, collapse, gv, v);
}

// _topo_nonempty_ok without building the row: every tightened key keeps a
// value allowed by the merged row and by all of its constraints.
__device__ bool nonempty_ok(const int* amask, u64 collapse, const TopoOut& t) {
  for (int c = 0; c < A.C; ++c) {
    if (!is_v(sh.ckind[c])) continue;
    const int kid = sh.ckid[c];
    bool seen = false;
    for (int c2 = 0; c2 < c; ++c2)
      if (is_v(sh.ckind[c2]) && sh.ckid[c2] == kid) seen = true;
    if (seen) continue;
    bool any = false;
    for (int v = 0; v < A.VMAX && !any; ++v) {
      if (!node_bit(amask, collapse, sh.cgv[c], v)) continue;
      bool all = true;
      for (int c2 = 0; c2 < A.C && all; ++c2)
        if (is_v(sh.ckind[c2]) && sh.ckid[c2] == kid && !cbit(c2, v, amask, collapse, t)) all = false;
      any = all;
    }
    if (!any) return false;
  }
  return true;
}

// the tighten word of constraint c for word w (delta in the reference)
__device__ unsigned delta_word(int c, int w, const int* amask, u64 collapse, const TopoOut& t) {
  const int gv = sh.cgv[c];
  unsigned d = 0;
  for (int v = 0; v < A.VMAX; ++v) {
    const long long o = (long long)gv * A.VMAX + v;
    if (sh.t_vword[o] == w && cbit(c, v, amask, collapse, t)) d |= 1u << sh.t_vbit[o];
  }
  return d;
}

// ---------------------------------------------------------------------------
// candidate screens against the staged pod (one thread per candidate)

// conflict_keys(a, pod): only the words and bounds of keys both rows define
// and do not both tolerate can conflict, so the others are never read.
__device__ __forceinline__ u64 pod_conflict(const Row& a, const RowKeys& ak, u64 abnd) {
  u64 conflict = 0;
  for (u64 cand = ak.defined & sh.pk.defined & ~(ak.tol & sh.pk.tol) & low_keys(A.K); cand; cand &= cand - 1) {
    const int k = __ffsll((long long)cand) - 1;
    bool nonempty = false;
    for (int w = sh.kw0[k]; w < sh.kw1[k] && !nonempty; ++w)
      nonempty = sh.w2k[w] == k && (a.mask[w] & sh.pmask[w]) != 0;
    if (!nonempty && ((ak.other & sh.pk.other) >> k) & 1)
      nonempty = (abnd >> k) & 1 ? max(a.gt[k], sh.pgt[k]) < min(a.lt[k], sh.plt[k]) : !((sh.pcollapse >> k) & 1);
    if (!nonempty) conflict |= kbit(k);
  }
  return conflict;
}

// Compatible(a, pod), topology and the tighten nonempty check of one
// candidate row (the claim screen, the cache's claim and existing screens).
__device__ bool screen_row(const Row& a, const RowKeys& ak, u64 abnd, int col, bool allow_wk) {
  if (!compat_keys(pod_conflict(a, ak, abnd), ak, sh.pk, allow_wk, sh.well_known)) return false;
  // the collapse only matters to zone-family constraints; off the keys the
  // row bounds it is the pod's own
  u64 collapse = 0;
  if (sh.any_v) {
    collapse = sh.pcollapse & ~abnd;
    for (u64 m = abnd; m; m &= m - 1) {
      const int k = __ffsll((long long)m) - 1;
      if (max(a.gt[k], sh.pgt[k]) >= min(a.lt[k], sh.plt[k])) collapse |= kbit(k);
    }
  }
  u64 touched;
  TopoOut t;
  return topo_eval(a.mask, collapse, col, touched, t) && nonempty_ok(a.mask, collapse, t);
}

__device__ bool screen_existing(int e, const KeyCache& kc) {
  const int R = A.R;
  if (!sh.ptol_e[e]) return false;
  for (int r = 0; r < R; ++r) {
    const int av = I32(eavail)[(long long)e * R + r];
    if (av < 0 || sh.preq[r] > av) return false;
  }
  for (int w = 0; w < A.HPW; ++w)
    if (sh.hp_conf[w] & I32(hp_used)[(long long)e * A.HPW + w]) return false;
  return screen_row(ROW(ereq, e), keys_at(kc.e, e), bnd_at(kc.e, e), e, false);
}

// ---------------------------------------------------------------------------
// the working row

// The prologue of a working row, by the 32 lanes of one warp: conflict and
// compat against the pod, the collapse and the topology. Lane 0 writes W.
__device__ void row_prologue(WorkRow& W, const Row& a, const RowKeys& ak, int col, bool allow_wk) {
  const int lane = threadIdx.x & 31;
  const int TW = A.TW, K = A.K;
  const u64 cand = ak.defined & sh.pk.defined & ~(ak.tol & sh.pk.tol) & low_keys(K);
  u64 seg = 0, bounds = 0;
  for (int w = lane; w < TW; w += 32) {
    const int key = sh.w2k[w];
    if (((cand >> key) & 1) && (a.mask[w] & sh.pmask[w]) != 0) seg |= kbit(key);
  }
  for (int k = lane; k < K; k += 32)
    if (max(a.gt[k], sh.pgt[k]) < min(a.lt[k], sh.plt[k])) bounds |= kbit(k);
  seg = warp_or(seg);
  bounds = warp_or(bounds);
  const u64 conflict = cand & ~(seg | (ak.other & sh.pk.other & bounds));
  const bool compat = compat_keys(conflict, ak, sh.pk, allow_wk, sh.well_known);
  const u64 collapse = low_keys(K) & ~bounds;  // max(gt) >= min(lt)
  u64 touched;
  const bool viable = topo_eval_warp(a.mask, collapse, col, touched, W.tout);
  if (lane == 0) {
    W.row_compat = compat;
    W.row_viable = viable;
    W.fcollapse = collapse;
    W.ftouched = touched;
    W.fother_m = ak.other & sh.pk.other & ~collapse;
    W.fk.defined = ak.defined | sh.pk.defined | touched;
    W.fk.other = W.fother_m & ~touched;
  }
}

// The keys the merged words decide, by the 32 lanes of one warp: notin,
// tol, the mask's key set, minValues and the bounds no type table needs.
__device__ void row_epilogue(WorkRow& W) {
  const int lane = threadIdx.x & 31;
  u64 segm = 0, segx = 0, b0 = 0;
  for (int w = lane; w < A.TW; w += 32) {
    const int key = sh.w2k[w];
    if (W.fmask[w] != 0) segm |= kbit(key);
    if (W.fex[w] != 0) segx |= kbit(key);
  }
  bool has = false;
  u64 bnd = 0;
  for (int k = lane; k < A.K; k += 32) {
    has = has || W.fminv[k] >= 0;
    if (!((sh.bkmask >> k) & 1) && W.fgt[k] < W.flt[k]) b0 |= kbit(k);
    if (W.fgt[k] != INT_MIN || W.flt[k] != INT_MAX) bnd |= kbit(k);
  }
  segm = warp_or(segm);
  segx = warp_or(segx);
  b0 = warp_or(b0);
  bnd = warp_or(bnd);
  has = __any_sync(FULL_MASK, has);
  if (lane == 0) {
    W.fk.notin = W.fk.other & segx;
    W.fk.tol = W.fk.notin | (~W.fk.other & ~segm);
    W.fsegm = segm;
    W.fhasminv = has;
    W.fbound0 = b0;
    W.fbnd = bnd;
  }
}

// Build the final row of candidate `a` (keys `ak`; merged with the pod,
// tightened by topology) into W; the whole team calls. Also leaves
// row_compat (Compatible(a, pod) with allow_wk) and row_viable (topology).
template <bool WARP>
__device__ void build_row(WorkRow& W, const Row& a, const RowKeys& ak, int col, bool allow_wk) {
  typedef Team<WARP> G;
  const int tid = G::rank();
  if (WARP || threadIdx.x < 32) row_prologue(W, a, ak, col, allow_wk);
  G::sync();
  const u64 collapse = W.fcollapse, touched = W.ftouched, other_m = W.fother_m;
  for (int w = tid; w < A.TW; w += G::size) {
    const int key = sh.w2k[w];
    const bool keep = !((collapse >> key) & 1);
    const int am = a.mask[w], ax = a.exmask[w], pm = sh.pmask[w], px = sh.pex[w];
    unsigned m = keep ? (unsigned)(am & pm) : 0u;
    unsigned x = (keep && ((other_m >> key) & 1)) ? (unsigned)((ax & (pm | px)) | (px & (am | ax))) : 0u;
    if ((touched >> key) & 1) {
      unsigned tight = (unsigned)sh.full[w];
      for (int c = 0; c < A.C; ++c)
        if (is_v(sh.ckind[c]) && sh.ckid[c] == key) tight &= delta_word(c, w, a.mask, collapse, W.tout);
      m &= tight;
      x = 0u;
    }
    W.fmask[w] = (int)m;
    W.fex[w] = (int)x;
  }
  for (int k = tid; k < A.K; k += G::size) {
    W.fgt[k] = max(a.gt[k], sh.pgt[k]);
    W.flt[k] = min(a.lt[k], sh.plt[k]);
    W.fminv[k] = max(a.minv[k], sh.pminv[k]);
  }
  G::sync();
  if (WARP || threadIdx.x < 32) row_epilogue(W);
  G::sync();
}

// Load a stored final row and its key masks into W; the whole team.
template <bool WARP>
__device__ void stage_final(WorkRow& W, const Row& r, const RowKeys& rk, u64 bnd) {
  typedef Team<WARP> G;
  const int tid = G::rank();
  G::sync();  // the previous working row's readers are done
  for (int w = tid; w < A.TW; w += G::size) {
    W.fmask[w] = r.mask[w];
    W.fex[w] = r.exmask[w];
  }
  for (int k = tid; k < A.K; k += G::size) {
    W.fgt[k] = r.gt[k];
    W.flt[k] = r.lt[k];
    W.fminv[k] = r.minv[k];
  }
  if (tid == 0) {
    W.fk = rk;
    W.fbnd = bnd;
  }
  G::sync();
  if (WARP || threadIdx.x < 32) {
    const int lane = threadIdx.x & 31;
    u64 b0 = 0;
    for (int k = lane; k < A.K; k += 32)
      if (!((sh.bkmask >> k) & 1) && W.fgt[k] < W.flt[k]) b0 |= kbit(k);
    b0 = warp_or(b0);
    if (lane == 0) W.fbound0 = b0;
  }
  G::sync();
}

// Type i's requirement row against the working row: conflict_keys(type i,
// W) == 0, from the type tables.
__device__ __forceinline__ bool type_compatible(const WorkRow& W, int i) {
  const int I = A.I;
  const u64 io = sh.t_keys[i], id = sh.t_keys[I + i], it = sh.t_keys[2 * I + i];
  const int* tm = sh.t_mask + i;
  for (u64 cand = id & W.fk.defined & ~(it & W.fk.tol) & low_keys(A.K); cand; cand &= cand - 1) {
    const int k = __ffsll((long long)cand) - 1;
    bool nonempty = false;
    for (int w = sh.kw0[k]; w < sh.kw1[k] && !nonempty; ++w)
      nonempty = sh.w2k[w] == k && (tm[(long long)w * I] & W.fmask[w]) != 0;
    if (!nonempty && ((io & W.fk.other) >> k) & 1) {
      const int j = sh.bkidx[k];
      nonempty = j < 0 ? (W.fbound0 >> k) & 1
                       : max(sh.t_bgt[(long long)j * I + i], W.fgt[k]) < min(sh.t_blt[(long long)j * I + i], W.flt[k]);
    }
    if (!nonempty) return false;
  }
  return true;
}

// one probe of an offering class (0xffff: none)
__device__ __forceinline__ bool probe_ok(const WorkRow& W, unsigned code) {
  return code == 0xffffu || (((unsigned)W.fmask[code >> 5] >> (code & 31)) & 1u);
}

// Surviving types of the working row (tpu_kernel.py _type_filter) into
// W.fi; returns whether any survives. mode 0: the alive words of claim
// `arg`; mode 1: template `arg`'s members filtered by its pool limits;
// mode 2: template `arg`'s members as they are. W.total holds the request
// total. The whole team calls.
template <bool WARP>
__device__ bool type_filter(WorkRow& W, int mode, int arg) {
  typedef Team<WARP> G;
  const int tid = G::rank();
  const int I = A.I, IW = A.IW, R = A.R;
  for (int w = tid; w < IW; w += G::size) W.offany[w] = 0u;
  G::sync();
  for (int x = tid; x < A.NOC * IW; x += G::size) {
    const int c = x / IW, w = x - c * IW;
    const unsigned p01 = (unsigned)sh.t_ocls[2 * c], p2 = (unsigned)sh.t_ocls[2 * c + 1];
    const unsigned m = (unsigned)sh.t_otyp[x];
    if (m && probe_ok(W, p01 & 0xffffu) && probe_ok(W, p01 >> 16) && probe_ok(W, p2)) atomicOr(&W.offany[w], m);
  }
  G::sync();
  // the candidate's own types: the claim's alive words or the template's members
  const int* own = mode == 0 ? I32(alive) + (long long)arg * IW : I32(ttypes) + (long long)arg * IW;
  for (int w = tid; w < IW; w += G::size) W.offany[w] &= (unsigned)own[w];
  G::sync();
  const bool limits = mode == 1 && U8(thas_limits)[arg];
  bool any = false;
  for (int base = 0; base < IW * 32; base += G::size) {
    const int i = base + tid;
    bool ok = false;
    if (i < I) {
      ok = (W.offany[i >> 5] >> (i & 31)) & 1u;
      if (ok && limits) {
        for (int r = 0; r < R; ++r)
          if (U8(tlimit_def)[arg * R + r] && I32(icap)[(long long)i * R + r] > I32(trem)[arg * R + r]) ok = false;
      }
      for (int r = 0; r < R && ok; ++r)
        if (W.total[r] > sh.t_alloc[(long long)r * I + i]) ok = false;
      if (ok) ok = type_compatible(W, i);
    }
    const unsigned word = __ballot_sync(FULL_MASK, ok);
    if ((tid & 31) == 0 && (i >> 5) < IW) W.fi[i >> 5] = word;
    any = any || word != 0u;
  }
  return G::any(any);
}

// SatisfiesMinValues over the surviving types (tpu_kernel.py
// _min_values_ok). All threads call.
__device__ bool min_values_ok(const WorkRow& W) {
  if (!W.fhasminv) return true;
  const int tid = threadIdx.x, I = A.I, TW = A.TW;
  for (int w = tid; w < TW; w += NT) sh.uni[w] = 0u;
  __syncthreads();
  for (int i = tid; i < I; i += NT) {
    if (!((W.fi[i >> 5] >> (i & 31)) & 1u)) continue;
    const u64 io = sh.t_keys[i], id = sh.t_keys[I + i];
    const int* ex = I32(ireq_exmask) + (long long)i * TW;
    for (int w = 0; w < TW; ++w) {
      const int key = sh.w2k[w];
      if (!((id >> key) & 1)) continue;
      const unsigned src = (unsigned)(((io >> key) & 1) ? ex[w] : sh.t_mask[(long long)w * I + i]);
      if (src) atomicOr(&sh.uni[w], src);
    }
  }
  __syncthreads();
  bool ok = true;
  if (tid < 32) {
    for (int k = tid; k < A.K; k += 32) {
      int count = 0;
      for (int w = 0; w < TW; ++w)
        if (sh.w2k[w] == k) count += __popc(sh.uni[w]);
      if (W.fminv[k] >= 0 && count < W.fminv[k]) ok = false;
    }
    ok = __all_sync(FULL_MASK, ok);
  }
  return !__syncthreads_or(tid == 0 && !ok);
}

// A final row to record or filter: a working row's arrays or a stored row.
struct FinalRow {
  const int* mask;
  const int* ex;
  const int* gt;
  const int* lt;
  RowKeys k;
};

__device__ __forceinline__ FinalRow final_of(const WorkRow& W) { return FinalRow{W.fmask, W.fex, W.fgt, W.flt, W.fk}; }

__device__ __forceinline__ FinalRow final_of(const Row& r, const RowKeys& k) {
  return FinalRow{r.mask, r.exmask, r.gt, r.lt, k};
}

// node_filter.matches(final row) for one group's filter alternatives
__device__ bool eval_filter(const FinalRow& f, const int* filt, bool allow_wk) {
  if (A.F == 0) return true;
  bool trivial = true, ok = false;
  for (int j = 0; j < A.FA; ++j) {
    const int alt = filt[j];
    if (alt >= 0) trivial = false;
    if (alt < 0) continue;
    const Row fr = ROW(freq, clampi(alt, 0, A.F - 1));
    const RowKeys fk = row_keys(fr, sh.w2k, A.TW, A.K);
    const u64 conflict = conflict_keys(f.mask, f.gt, f.lt, f.k, fr.mask, fr.gt, fr.lt, fk, sh.w2k, A.TW, A.K);
    if (compat_keys(conflict, f.k, fk, allow_wk, sh.well_known)) ok = true;
  }
  return trivial || ok;
}

// Write the working row into a row of device memory; the whole team.
template <bool WARP>
__device__ void write_row(const Row& dst, const WorkRow& W) {
  typedef Team<WARP> G;
  const int tid = G::rank();
  for (int w = tid; w < A.TW; w += G::size) {
    ((int*)dst.mask)[w] = W.fmask[w];
    ((int*)dst.exmask)[w] = W.fex[w];
  }
  for (int k = tid; k < A.K; k += G::size) {
    ((uint8_t*)dst.other)[k] = (W.fk.other >> k) & 1;
    ((uint8_t*)dst.notin)[k] = (W.fk.notin >> k) & 1;
    ((uint8_t*)dst.defined)[k] = (W.fk.defined >> k) & 1;
    ((int*)dst.gt)[k] = W.fgt[k];
    ((int*)dst.lt)[k] = W.flt[k];
    ((int*)dst.minv)[k] = W.fminv[k];
  }
}

// column max over the surviving types of the allocatable table into W.red
template <bool WARP>
__device__ void surviving_max_alloc(WorkRow& W) {
  typedef Team<WARP> G;
  const int tid = G::rank(), I = A.I;
  for (int r = tid; r < A.R; r += G::size) W.red[r] = -INF_I;
  G::sync();
  for (int i = tid; i < I; i += G::size) {
    if (!((W.fi[i >> 5] >> (i & 31)) & 1u)) continue;
    for (int r = 0; r < A.R; ++r) atomicMax(&W.red[r], sh.t_alloc[(long long)r * I + i]);
  }
  G::sync();
}

// column max over the surviving types of `tab` [I, R] into W.red
__device__ void surviving_max(WorkRow& W, const int* tab, int init) {
  const int tid = threadIdx.x;
  for (int r = tid; r < A.R; r += NT) W.red[r] = init;
  __syncthreads();
  for (int i = tid; i < A.I; i += NT) {
    if (!((W.fi[i >> 5] >> (i & 31)) & 1u)) continue;
    for (int r = 0; r < A.R; ++r) atomicMax(&W.red[r], tab[(long long)i * A.R + r]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the prologue and the per-pod staging

__device__ void stage_vocab() {
  const int tid = threadIdx.x;
  for (int w = tid; w < A.TW; w += NT) {
    sh.w2k[w] = I32(word2key)[w];
    sh.full[w] = I32(full_mask)[w];
  }
  if (tid == 0) sh.well_known = key_mask(U8(well_known), A.K);
  __syncthreads();
  for (int k = tid; k < A.K; k += NT) {
    int w0 = A.TW, w1 = 0;
    for (int w = 0; w < A.TW; ++w)
      if (sh.w2k[w] == k) {
        w0 = min(w0, w);
        w1 = w + 1;
      }
    sh.kw0[k] = w0;
    sh.kw1[k] = w1;
  }
  __syncthreads();
}

// The instance types' key masks (row_keys of each ireq row, threads over
// I) into the key cache: other, defined, tol. All threads; the caller
// syncs before reading them.
__device__ void type_keys(const KeyCache& kc) {
  const int I = A.I;
  for (int i = threadIdx.x; i < I; i += NT) {
    const RowKeys k = row_keys(ROW(ireq, i), sh.w2k, A.TW, A.K);
    kc.t[i] = k.other;
    kc.t[I + i] = k.defined;
    kc.t[2 * I + i] = k.tol;
  }
}

// The launch prologue of the step kernels: the vocabulary, the types' key
// masks, the type tables (`budget` bytes of them in shared memory, beside
// `nrows` working rows), the templates' key masks, the hostname groups'
// nonempty flags, and the key masks of every claim slot and existing node
// as handed in. All threads.
__device__ void step_prologue(long long budget, int nrows, const KeyCache& kc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_vocab();
  type_keys(kc);
  __syncthreads();
  stage_tables(budget, nrows, kc.t);
  for (int t = tid; t < A.T; t += NT) {
    const RowKeys k = row_keys(ROW(treq, t), sh.w2k, A.TW, A.K);
    sh.tkeys[0][t] = k.other;
    sh.tkeys[1][t] = k.notin;
    sh.tkeys[2][t] = k.defined;
    sh.tkeys[3][t] = k.tol;
    sh.tkeys[4][t] = row_bnd(ROW(treq, t));
  }
  for (int g = warp; g < A.Gh; g += NWARP) {
    bool any = false;
    for (int s = lane; s < A.S && !any; s += 32) any = I32(h_cnt)[(long long)g * A.S + s] > 0;
    any = __any_sync(FULL_MASK, any);
    if (lane == 0) sh.hne[g] = any;
  }
  for (int n = tid; n < A.N; n += NT)
    keys_put(kc.c, n, row_keys(ROW(creq, n), sh.w2k, A.TW, A.K), row_bnd(ROW(creq, n)));
  for (int e = tid; e < A.E; e += NT)
    keys_put(kc.e, e, row_keys(ROW(ereq, e), sh.w2k, A.TW, A.K), row_bnd(ROW(ereq, e)));
  __syncthreads();
}

// The rows of a pod that depend on its relaxation tier (the fields
// tpu_kernel.py _x_at_tier substitutes): the requirement row, the type
// screen, the tolerations and the owned topology constraints.
struct PodRows {
  Row req;
  const int* typeok;
  const uint8_t* tol_t;
  const uint8_t* tol_e;
  const int* kind;
  const int* gid;
  const uint8_t* sel;
};

// batch row p: the pod as submitted
__device__ PodRows pod_rows(int p) {
  return PodRows{ROW(preq, p),
                 I32(typeok) + (long long)p * A.IW,
                 U8(tol_t) + (long long)p * A.T,
                 U8(tol_e) + (long long)p * A.E,
                 I32(topo_kind) + (long long)p * A.C,
                 I32(topo_gid) + (long long)p * A.C,
                 U8(topo_sel) + (long long)p * A.C};
}

// tier t of relaxable class row r (both clamped, as JAX clamps a gather;
// the host only hands real rows and t < ntiers <= L)
__device__ PodRows tier_rows(int r, int t) {
  const long long i = (long long)clampi(r, 0, A.NRX - 1) * A.L + clampi(t, 0, A.L - 1);
  return PodRows{ROW(rt_preq, i),
                 I32(rt_typeok) + i * A.IW,
                 U8(rt_tol_t) + i * A.T,
                 U8(rt_tol_e) + i * A.E,
                 I32(rt_kind) + i * A.C,
                 I32(rt_gid) + i * A.C,
                 U8(rt_sel) + i * A.C};
}

// Stage the tier-dependent rows and the per-constraint scalars derived from
// them (which read the current v_cnt); all threads call, after a barrier
// that ends every read of the rows staged before.
__device__ void stage_rows(const PodRows& pr) {
  const int tid = threadIdx.x;
  const int TW = A.TW, K = A.K, IW = A.IW;
  for (int w = tid; w < TW; w += NT) {
    sh.pmask[w] = pr.req.mask[w];
    sh.pex[w] = pr.req.exmask[w];
  }
  for (int k = tid; k < K; k += NT) {
    sh.pgt[k] = pr.req.gt[k];
    sh.plt[k] = pr.req.lt[k];
    sh.pminv[k] = pr.req.minv[k];
  }
  for (int w = tid; w < IW; w += NT) sh.typeok[w] = pr.typeok[w];
  for (int c = tid; c < A.C; c += NT) {
    sh.ckind[c] = pr.kind[c];
    sh.cgid[c] = pr.gid[c];
    sh.csel[c] = pr.sel[c] ? 1 : 0;
  }
  if (tid == 0) {
    sh.ptol_t = pr.tol_t;
    sh.ptol_e = pr.tol_e;
  }
  __syncthreads();
  if (tid < 32) {
    // the pod's key masks (row_keys), lanes over keys and words
    u64 o = 0, n = 0, d = 0, seg = 0;
    for (int k = tid; k < K; k += 32) {
      if (pr.req.other[k]) o |= kbit(k);
      if (pr.req.notin[k]) n |= kbit(k);
      if (pr.req.defined[k]) d |= kbit(k);
    }
    for (int w = tid; w < TW; w += 32)
      if (sh.pmask[w] != 0) seg |= kbit(sh.w2k[w]);
    o = warp_or(o);
    n = warp_or(n);
    d = warp_or(d);
    seg = warp_or(seg);
    u64 pc = 0;
    for (int k = tid; k < K; k += 32)
      if (sh.pgt[k] >= sh.plt[k]) pc |= kbit(k);
    pc = warp_or(pc);
    bool anyv = false;
    for (int c = tid; c < A.C; c += 32) anyv = anyv || is_v(sh.ckind[c]);
    anyv = __any_sync(FULL_MASK, anyv);
    if (tid == 0) {
      sh.pk = RowKeys{o, n, d, n | (~o & ~seg)};
      sh.pcollapse = pc;
      sh.any_v = anyv;
    }
  }
  for (int c = tid; c < A.C; c += NT) {
    const int gv = clampi(sh.cgid[c], 0, A.Gv - 1);
    const long long base = (long long)gv * A.VMAX;
    sh.cgv[c] = gv;
    sh.ckid[c] = I32(v_kid)[gv];
    sh.cskew[c] = I32(v_skew)[gv];
    int mn = INF_I, nsup = 0;
    bool nonempty_total = false, any_compat = false;
    for (int v = 0; v < A.VMAX; ++v) {
      const bool reg = sh.t_vreg[base + v];
      const int cnt = I32(v_cnt)[base + v];
      const bool pd = pod_bit(gv, v);
      if (reg && pd) {
        mn = min(mn, cnt);
        ++nsup;
      }
      if (reg && cnt > 0) {
        nonempty_total = true;
        if (pd) any_compat = true;
      }
    }
    const int mindom = I32(v_mindom)[gv];
    if (mindom >= 0 && nsup < mindom) mn = 0;
    sh.cmin[c] = mn;
    sh.cboot[c] = sh.csel[c] > 0 && (!nonempty_total || !any_compat);
  }
  __syncthreads();
}

// Stage pod p: the rows that stay the pod's own at every tier (requests,
// selection, inverse and host-port rows), the nonempty hostname groups (kept
// current in sh.hne), and its tier-0 rows as submitted; all threads call.
__device__ void stage_pod(int p) {
  const int tid = threadIdx.x;
  const int R = A.R;
  for (int r = tid; r < R; r += NT) sh.preq[r] = I32(prequests)[(long long)p * R + r];
  for (int g = tid; g < A.Gv; g += NT) sh.sel_v[g] = U8(sel_v)[(long long)p * A.Gv + g];
  for (int g = tid; g < A.Gh; g += NT) {
    sh.sel_h[g] = U8(sel_h)[(long long)p * A.Gh + g];
    sh.inv_h[g] = U8(inv_h)[(long long)p * A.Gh + g];
    sh.own_h[g] = U8(own_h)[(long long)p * A.Gh + g];
    sh.ne_h[g] = sh.hne[g];
  }
  for (int w = tid; w < A.HPW; w += NT) {
    sh.hp_own[w] = I32(hp_own)[(long long)p * A.HPW + w];
    sh.hp_conf[w] = I32(hp_conf)[(long long)p * A.HPW + w];
  }
  if (tid == 0) {
    sh.valid = U8(valid)[p];
    sh.n_claims = *I32(n_claims);
  }
  stage_rows(pod_rows(p));
}

// The topology record (tpu_kernel.py _record) of final row `f` committed at
// global slot `slot_global`, for a pod with the given selection rows.
// Thread t owns groups t, t + NT, ..., so successive calls need no barrier
// between them as long as their rows stay put; the owner keeps the group's
// nonempty flag current.
__device__ void record_row(const FinalRow& f, int slot_global, bool allow_wk, const uint8_t* sel_v,
                           const uint8_t* sel_h, const uint8_t* own_h) {
  const int tid = threadIdx.x, K = A.K;
  for (int g = tid; g < A.Gv; g += NT) {
    const long long base = (long long)g * A.VMAX;
    const int kid = clampi(I32(v_kid)[g], 0, K - 1);
    const bool other_k = (f.k.other >> kid) & 1;
    int popc = 0;
    for (int v = 0; v < A.VMAX; ++v) {
      const int w = sh.t_vword[base + v];
      if (w >= 0 && (((unsigned)f.mask[w] >> sh.t_vbit[base + v]) & 1u)) ++popc;
    }
    const bool single = popc == 1 && !other_k;
    if (!(sel_v[g] && eval_filter(f, I32(v_filt) + (long long)g * A.FA, allow_wk))) continue;
    const bool anti = U8(v_anti)[g];
    for (int v = 0; v < A.VMAX; ++v) {
      const int w = sh.t_vword[base + v];
      if (w < 0) continue;
      const int b = sh.t_vbit[base + v];
      const bool seg = ((unsigned)f.mask[w] >> b) & 1u;
      const bool ex = ((unsigned)f.ex[w] >> b) & 1u;
      const bool add = anti ? (other_k ? ex : seg) : (seg && single);
      if (add) I32(v_cnt)[base + v] += 1;
    }
  }
  for (int g = tid; g < A.Gh; g += NT) {
    const bool contrib =
        U8(h_inverse)[g] ? own_h[g] : (sel_h[g] && eval_filter(f, I32(h_filt) + (long long)g * A.FA, allow_wk));
    if (contrib && slot_global < A.S) {
      const int nv = ++I32(h_cnt)[(long long)g * A.S + slot_global];
      if (nv > 0) sh.hne[g] = 1;
    }
  }
}

// The staged pod's exact decision and commit, after stage_pod (and, for a
// tier, stage_rows); all threads call and all get the result. Returns the
// output slot (-1 when the pod fails) and sets `kind` and `over` (a
// template fits but every claim slot is taken: nothing is committed).
__device__ int exact_step(const KeyCache& kc, int& kind, int& over) {
  const int tid = threadIdx.x;
  const int R = A.R, E = A.E, N = A.N, T = A.T, IW = A.IW;
  const bool valid = sh.valid;
  const int n_claims = sh.n_claims;
  WorkRow& F = wrow(0);
  int slot_e = 0, slot_c = 0, slot_t = 0;
  kind = KIND_FAIL;
  over = 0;

  if (valid) {
    // ---- 1. existing nodes, first candidate in fixed order ----
    if (E > 0) {
      int best = INT_MAX;
      for (int e = tid; e < E; e += NT)
        if (best == INT_MAX && screen_existing(e, kc)) best = e;
      block_argmin(best, best);
      prof_mark(PH_existing_screen);
      if (sh.best_key != INT_MAX) {
        kind = KIND_EXISTING;
        slot_e = sh.best_key;
        build_row<false>(F, ROW(ereq, slot_e), keys_at(kc.e, slot_e), slot_e, false);
        prof_mark(PH_verify_build_row);
      }
    }
    // ---- 2. claim screen ----
    if (kind == KIND_FAIL) {
      const uint8_t* tol_t = sh.ptol_t;
      for (int n = tid; n < N; n += NT) {
        bool ok = U8(active)[n] && tol_t[clampi(I32(tmpl)[n], 0, T > 0 ? T - 1 : 0)];
        for (int r = 0; r < R && ok; ++r)
          if (I32(crequests)[(long long)n * R + r] + sh.preq[r] > I32(cmax_alloc)[(long long)n * R + r])
            ok = false;
        if (ok) {
          bool types = false;
          for (int w = 0; w < IW && !types; ++w)
            types = (I32(alive)[(long long)n * IW + w] & sh.typeok[w]) != 0;
          ok = types;
        }
        for (int w = 0; w < A.HPW && ok; ++w)
          if (sh.hp_conf[w] & I32(hp_used)[(long long)(E + n) * A.HPW + w]) ok = false;
        if (ok) ok = screen_row(ROW(creq, n), keys_at(kc.c, n), bnd_at(kc.c, n), E + n, true);
        U8(cand)[n] = ok;
      }
      __syncthreads();
      prof_mark(PH_claim_screen);
      // ---- 3. exact verify in rank order ----
      while (true) {
        int bk = INT_MAX, bi = INT_MAX;
        for (int n = tid; n < N; n += NT)
          if (U8(cand)[n]) {
            const int r = I32(rank)[n];
            if (r < bk || (r == bk && n < bi)) {
              bk = r;
              bi = n;
            }
          }
        block_argmin(bk, bi);
        prof_mark(PH_verify_argmin);
        const int n = sh.best_idx;
        if (n == INT_MAX) break;
        build_row<false>(F, ROW(creq, n), keys_at(kc.c, n), E + n, true);
        for (int r = tid; r < R; r += NT) F.total[r] = I32(crequests)[(long long)n * R + r] + sh.preq[r];
        __syncthreads();
        prof_mark(PH_verify_build_row);
        bool ok = type_filter<false>(F, 0, n);
        prof_mark(PH_verify_type_filter);
        if (ok) {
          ok = min_values_ok(F);
          prof_mark(PH_verify_min_values);
        }
        if (ok) {
          kind = KIND_CLAIM;
          slot_c = n;
          break;
        }
        if (tid == 0) U8(cand)[n] = 0;
        __syncthreads();
        prof_mark(PH_verify_argmin);
      }
    }
    // ---- 4. new claim from the first viable template ----
    if (kind == KIND_FAIL) {
      for (int t = 0; t < T; ++t) {
        build_row<false>(F, ROW(treq, t), tmpl_keys(t), -1, true);
        bool quick = false;
        if (tid == 0) {
          quick = F.row_compat && F.row_viable && (F.ftouched & ~F.fsegm) == 0 && sh.ptol_t[t];
          for (int w = 0; w < A.HPW && quick; ++w)
            if (sh.hp_conf[w] & I32(thp)[t * A.HPW + w]) quick = false;
        }
        if (!__syncthreads_or(quick)) continue;
        for (int r = tid; r < R; r += NT) F.total[r] = I32(tdaemon)[t * R + r] + sh.preq[r];
        __syncthreads();
        if (type_filter<false>(F, 1, t) && min_values_ok(F)) {
          if (n_claims < N) {
            kind = KIND_NEW;
            slot_t = t;
          } else {
            over = 1;
          }
          break;
        }
      }
      prof_sync(PH_template_branch);
    }
  }

  // ---- 5. commit ----
  const int m = n_claims;
  int slot_global = 0;
  if (kind == KIND_EXISTING) {
    for (int r = tid; r < R; r += NT) I32(eavail)[(long long)slot_e * R + r] -= sh.preq[r];
    write_row<false>(ROW(ereq, slot_e), F);
    if (tid == 0) keys_put(kc.e, slot_e, F.fk, F.fbnd);
    slot_global = slot_e;
  } else if (kind == KIND_CLAIM) {
    const int j = slot_c;
    if (tid == 0) {
      sh.rank_j = I32(rank)[j];
      sh.count_j = I32(count)[j];
    }
    __syncthreads();
    const int rank_j = sh.rank_j, cnew = sh.count_j + 1;
    int bk = INT_MAX;
    for (int n = tid; n < N; n += NT)
      if (n != j && U8(active)[n] && I32(count)[n] >= cnew) bk = min(bk, I32(rank)[n]);
    block_argmin(bk, 0);
    const int boundary = min(min(sh.best_key, INF_I), n_claims);
    for (int n = tid; n < N; n += NT) {
      if (n == j) {
        I32(rank)[n] = boundary - 1;
        I32(count)[n] = cnew;
      } else {
        const int r = I32(rank)[n];
        if (r > rank_j && r < boundary) I32(rank)[n] = r - 1;
      }
    }
    prof_sync(PH_commit_rank);
    write_row<false>(ROW(creq, j), F);
    if (tid == 0) keys_put(kc.c, j, F.fk, F.fbnd);
    for (int r = tid; r < R; r += NT) I32(crequests)[(long long)j * R + r] += sh.preq[r];
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)j * IW + w] = (int)F.fi[w];
    prof_sync(PH_commit_other);
    surviving_max_alloc<false>(F);
    prof_mark(PH_commit_surviving_max);
    for (int r = tid; r < R; r += NT) I32(cmax_alloc)[(long long)j * R + r] = F.red[r];
    slot_global = E + j;
  } else if (kind == KIND_NEW) {
    int bk = INT_MAX;
    for (int n = tid; n < N; n += NT)
      if (U8(active)[n] && I32(count)[n] >= 2) bk = min(bk, I32(rank)[n]);
    block_argmin(bk, 0);
    const int boundary = min(min(sh.best_key, INF_I), n_claims);
    for (int n = tid; n < N; n += NT) {
      if (n == m)
        I32(rank)[n] = boundary;
      else if (U8(active)[n] && I32(rank)[n] >= boundary)
        I32(rank)[n] += 1;
    }
    prof_sync(PH_commit_rank);
    write_row<false>(ROW(creq, m), F);
    if (tid == 0) keys_put(kc.c, m, F.fk, F.fbnd);
    for (int r = tid; r < R; r += NT)
      I32(crequests)[(long long)m * R + r] = I32(tdaemon)[slot_t * R + r] + sh.preq[r];
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)m * IW + w] = (int)F.fi[w];
    prof_sync(PH_commit_other);
    surviving_max_alloc<false>(F);
    for (int r = tid; r < R; r += NT) I32(cmax_alloc)[(long long)m * R + r] = F.red[r];
    __syncthreads();
    if (U8(thas_limits)[slot_t]) {
      // subtractMax on the template's pool limits
      surviving_max(F, I32(icap), 0);
      for (int r = tid; r < R; r += NT)
        if (U8(tlimit_def)[slot_t * R + r]) I32(trem)[slot_t * R + r] -= F.red[r];
    }
    prof_sync(PH_commit_surviving_max);
    if (tid == 0) {
      I32(count)[m] = 1;
      U8(active)[m] = 1;
      I32(tmpl)[m] = slot_t;
      *I32(n_claims) = m + 1;
    }
    slot_global = E + m;
  }

  // reservations: the committed claim's held set, recomputed
  if (A.NRES > 0 && (kind == KIND_CLAIM || kind == KIND_NEW)) {
    const int slot_r = kind == KIND_CLAIM ? slot_c : m;
    for (int w = tid; w < A.NRESW; w += NT) sh.cand_r[w] = 0u;
    __syncthreads();
    for (int o = tid; o < A.O; o += NT) {
      const int rid = I32(orid)[o];
      if (rid < 0 || !U8(ovalid)[o]) continue;
      const int t = clampi(I32(otype)[o], 0, A.I - 1);
      if (!((F.fi[t >> 5] >> (t & 31)) & 1u)) continue;
      bool ok = true;
      for (int j = 0; j < 3; ++j) {
        const int w = I32(oword)[o * 3 + j];
        if (w >= 0 && !(((unsigned)F.fmask[w] >> I32(obit)[o * 3 + j]) & 1u)) ok = false;
      }
      if (ok && rid < A.NRES) atomicOr(&sh.cand_r[rid >> 5], 1u << (rid & 31));
    }
    __syncthreads();
    if (tid == 0) {
      int* held = I32(held) + (long long)slot_r * A.NRESW;
      for (int w = 0; w < A.NRESW; ++w) {
        unsigned nw = 0u;
        for (int b = 0; b < 32; ++b) {
          const int r = w * 32 + b;
          if (r >= A.NRES) break;
          const int old = ((unsigned)held[w] >> b) & 1u;
          const int cand = (sh.cand_r[w] >> b) & 1u;
          const int nh = cand && (old || I32(rescap)[r] > 0);
          I32(rescap)[r] -= nh - old;
          if (nh) nw |= 1u << b;
        }
        held[w] = (int)nw;
      }
    }
    prof_sync(PH_commit_reservations);
  }

  // topology record and host ports
  if (kind != KIND_FAIL) {
    record_row(final_of(F), slot_global, kind != KIND_EXISTING, sh.sel_v, sh.sel_h, sh.own_h);
    for (int w = tid; w < A.HPW; w += NT) {
      int add = sh.hp_own[w];
      if (kind == KIND_NEW) add |= I32(thp)[clampi(slot_t, 0, T > 0 ? T - 1 : 0) * A.HPW + w];
      I32(hp_used)[(long long)slot_global * A.HPW + w] |= add;
    }
  }
  prof_sync(kind == KIND_FAIL ? PH_other : PH_commit_record);
  return kind == KIND_EXISTING ? slot_e : kind == KIND_CLAIM ? slot_c : kind == KIND_NEW ? m : -1;
}

// Fold one pod's tier-loop trips into the counter block (tpu_kernel.py
// odo_tier_tick): bins 0..KTPU_TIER_BINS-2 count the pods whose trips exceed
// the bin index, the last bin takes max(trips - its index, 0). Thread 0
// calls.
__device__ void tier_tick(int trips) {
  int* cnt = I32(counters);
  const int last = KTPU_TIER_BINS - 1;
  cnt[KTPU_CNT_TIER_STEPS] += trips;
  for (int b = 0; b < last; ++b) cnt[KTPU_CNT_TIER_STEPS + 1 + b] += trips > b;
  cnt[KTPU_CNT_TIER_STEPS + 1 + last] += max(trips - last, 0);
}

// Batch row p through its preference ladder (tpu_kernel.py _step_relax),
// after stage_pod(p): tier t stages the tier-t rows of the pod's relaxable
// class and takes the exact step, until a tier places the pod
// (kind != KIND_FAIL), overflows the claim slots, or the ladder ends; an
// invalid position takes one trip. A single-tier pod keeps the rows
// stage_pod staged and takes exactly one trip; its rrow is a placeholder
// and is never read. Returns the trips; sets kind, over and slot as
// exact_step does. All threads call.
__device__ int relax_step(int p, const KeyCache& kc, int& kind, int& over, int& slot) {
  const int nt = I32(ntiers)[p];
  const bool tiered = nt > 1;
  const int r = tiered ? I32(rrow)[p] : 0;
  int trips = 0;
  kind = KIND_FAIL;
  over = 0;
  slot = -1;
  while (trips < nt) {
    if (tiered) {
      __syncthreads();  // the previous tier's reads of the staged rows are done
      stage_rows(tier_rows(r, trips));
      prof_mark(PH_restage);
    }
    slot = exact_step(kc, kind, over);
    ++trips;
    if (kind != KIND_FAIL || over || !sh.valid) break;
  }
  return trips;
}

// The scan walk (tpu_kernel.py solve_scan): the batch's pods in order, each
// staged and taken through the exact step or, with relax, the tier loop;
// kinds and slots per pod, then the counter block's overflow and steps. K2
// walks it in its one CTA, K7 in each lane's CTA; the scratch block is the
// KeyCache and one working row the dynamic shared memory's head. All
// threads call.
__device__ __forceinline__ void scan_walk() {
  prof_begin();
  KeyCache kc;
  Carver cv{scratch_base(), 0};
  carve_key_cache(cv, A, kc);
  step_prologue(A.SMB, 1, kc);
  prof_mark(PH_prologue);
  int over_any = 0;
  for (int p = 0; p < A.P; ++p) {
    stage_pod(p);
    prof_mark(PH_stage_pod);
    int kind, over, slot;
    if (A.relax) {
      const int trips = relax_step(p, kc, kind, over, slot);
      if (threadIdx.x == 0) tier_tick(trips);
    } else {
      slot = exact_step(kc, kind, over);
    }
    if (threadIdx.x == 0) {
      I32(kinds)[p] = kind;
      I32(slots)[p] = slot;
    }
    over_any |= over;
    __syncthreads();
    prof_mark(PH_other);
  }
  if (threadIdx.x == 0) {
    I32(counters)[0] = over_any;
    I32(counters)[1] = A.P;
  }
  prof_end();
}

// The extern "C" names every step library exports beside its launch: the
// argument block's fields, the breakdown's phases, the block's size and the last
// launch's table layout.
#define KTPU_STR_NAME(name) #name ","
#define KTPU_STEP_EXPORTS(name)                                                                        \
  static const char name##_fields[] =                                                                  \
      KTPU_STEP_PTR_FIELDS(KTPU_STR_NAME) "|" KTPU_STEP_INT_FIELDS(KTPU_STR_NAME);                     \
  static const char name##_phases[] = KTPU_PHASES(KTPU_STR_NAME);                                      \
  extern "C" const char* name##_field_names() { return name##_fields; }                                \
  extern "C" const char* name##_phase_names() { return name##_phases; }                                \
  extern "C" int name##_args_size() { return (int)sizeof(StepArgs); }                                  \
  extern "C" void name##_last_layout(long long* out) {                                                 \
    const TabLayout& L = last_layout();                                                                \
    const long long v[7] = {L.topo, L.keys, L.off, L.alloc, L.bounds, L.mask, L.bytes};                        \
    for (int i = 0; i < 7; ++i) out[i] = v[i];                                                         \
  }
