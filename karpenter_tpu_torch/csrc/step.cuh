// The exact per-pod FFD step as device code, shared by K2 scan_step
// (scan_step.cu) and K3 run_step (run_step.cu).
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
//      candidates' (rank, index), the final row built in shared memory, the
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
#include <stdint.h>

#include "algebra.cuh"
#include "step_args.h"

using namespace ktpu;

#define NT 512
#define NWARP (NT / 32)
#define INF_I (1 << 30)

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
// K7 scan_lanes: one CTA per lane. A holds lane 0's addresses; a field
// that varies by lane (the state, the valid row, the outputs and the
// claim-screen scratch) has its lanes laid out one after another, `LS.f`
// elements apart, and every access adds blockIdx.x lanes of that stride
// (0 for the tables and the shared pod rows). The library without the
// define (K2, K3) reads A as it is.
struct LaneStrides {
#define KTPU_DECL_STRIDE(name) long long name;
  KTPU_STEP_PTR_FIELDS(KTPU_DECL_STRIDE)
#undef KTPU_DECL_STRIDE
};
__constant__ LaneStrides LS;
#define I32(f) ((int*)A.f + (long long)blockIdx.x * LS.f)
#define U8(f) ((uint8_t*)A.f + (long long)blockIdx.x * LS.f)
#else
#define I32(f) ((int*)A.f)
#define U8(f) ((uint8_t*)A.f)
#endif
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

struct Shared {
  int w2k[KTPU_MAX_TW];
  int full[KTPU_MAX_TW];
  u64 well_known;
  // the pod
  int pmask[KTPU_MAX_TW], pex[KTPU_MAX_TW];
  int pgt[KTPU_MAX_K], plt[KTPU_MAX_K], pminv[KTPU_MAX_K];
  RowKeys pk;
  int preq[KTPU_MAX_R];
  int typeok[KTPU_MAX_IW];
  int hp_own[KTPU_MAX_HPW], hp_conf[KTPU_MAX_HPW];
  uint8_t sel_v[KTPU_MAX_G], sel_h[KTPU_MAX_G], inv_h[KTPU_MAX_G], own_h[KTPU_MAX_G], ne_h[KTPU_MAX_G];
  int ckind[KTPU_MAX_C], cgid[KTPU_MAX_C], csel[KTPU_MAX_C], cgv[KTPU_MAX_C], ckid[KTPU_MAX_C];
  int cskew[KTPU_MAX_C], cmin[KTPU_MAX_C], cboot[KTPU_MAX_C];
  const uint8_t* ptol_t;  // [T] the staged rows' template tolerations
  const uint8_t* ptol_e;  // [E] and existing-node tolerations
  int valid, n_claims;
  // the working row: one candidate's final (merged + tightened) row
  int fmask[KTPU_MAX_TW], fex[KTPU_MAX_TW];
  int fgt[KTPU_MAX_K], flt[KTPU_MAX_K], fminv[KTPU_MAX_K];
  RowKeys fk;
  u64 fcollapse, fother_m, ftouched, fsegm;
  int fhasminv;
  int row_compat, row_viable;
  TopoOut tout;
  unsigned fi[KTPU_MAX_IW];      // surviving types of the working row
  unsigned offany[KTPU_MAX_IW];  // types with a matching offering
  unsigned uni[KTPU_MAX_TW];     // minValues union
  int total[KTPU_MAX_R];
  int red[KTPU_MAX_R];
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
  int r_case, r_k, r_t, r_hbf, nseq;
  int wtgt[KTPU_RUN_W], worder[KTPU_RUN_W], wok[KTPU_RUN_W];
};

__shared__ Shared sh;

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

__device__ __forceinline__ bool is_v(int kind) { return kind >= TOPO_SPREAD_V && kind <= TOPO_ANTI_V; }

// Block-wide argmin over (key, idx), ties to the lower idx; all threads
// call it. Result in sh.best_key/best_idx (INT_MAX when nothing offered).
__device__ void block_argmin(int key, int idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    int k2 = __shfl_down_sync(0xffffffffu, key, off);
    int i2 = __shfl_down_sync(0xffffffffu, idx, off);
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

// ---------------------------------------------------------------------------
// topology (tpu_kernel.py _eval_topology), one candidate per call

__device__ __forceinline__ int hcnt(int g, int col) {
  return col < 0 ? 0 : I32(h_cnt)[(long long)g * A.S + col];
}

// bit v of group gv in the merged row (candidate a ∧ pod, bounds folded)
__device__ __forceinline__ bool node_bit(const int* amask, u64 collapse, int gv, int v) {
  const long long o = (long long)gv * A.VMAX + v;
  const int w = I32(v_word)[o];
  if (w < 0) return false;
  if ((collapse >> sh.w2k[w]) & 1) return false;
  const unsigned m = (unsigned)(amask[w] & sh.pmask[w]);
  return (m >> I32(v_bit)[o]) & 1u;
}

__device__ __forceinline__ bool pod_bit(int gv, int v) {
  const long long o = (long long)gv * A.VMAX + v;
  const int w = I32(v_word)[o];
  if (w < 0) return false;
  return ((unsigned)sh.pmask[w] >> I32(v_bit)[o]) & 1u;
}

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
        if (!U8(v_reg)[base + v] || !node_bit(amask, collapse, gv, v)) continue;
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
        if (!U8(v_reg)[base + v] || !pod_bit(gv, v) || !node_bit(amask, collapse, gv, v)) continue;
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
        any = U8(v_reg)[base + v] && I32(v_cnt)[base + v] == 0 && pod_bit(gv, v) &&
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

// bit v of constraint c's chosen domain set for this candidate
__device__ __forceinline__ bool cbit(int c, int v, const int* amask, u64 collapse, const TopoOut& t) {
  const int kind = sh.ckind[c], gv = sh.cgv[c];
  const long long o = (long long)gv * A.VMAX + v;
  if (kind == TOPO_SPREAD_V) return (t.flags[c] & 1) && v == t.first[c];
  if (kind == TOPO_AFFINITY_V) {
    if (t.flags[c] & 2)
      return U8(v_reg)[o] && I32(v_cnt)[o] > 0 && pod_bit(gv, v) && node_bit(amask, collapse, gv, v);
    return (t.flags[c] & 4) && v == t.bfirst[c];
  }
  return U8(v_reg)[o] && I32(v_cnt)[o] == 0 && pod_bit(gv, v) && node_bit(amask, collapse, gv, v);
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
    if (I32(v_word)[o] == w && cbit(c, v, amask, collapse, t)) d |= 1u << I32(v_bit)[o];
  }
  return d;
}

// ---------------------------------------------------------------------------
// the working row

// Build the final row of candidate `a` (merged with the pod, tightened by
// topology) into shared memory; all threads call. Also leaves row_compat
// (Compatible(a, pod) with allow_wk) and row_viable (topology).
__device__ void build_row(const Row& a, int col, bool allow_wk) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    const RowKeys ak = row_keys(a, sh.w2k, A.TW, A.K);
    const u64 conflict =
        conflict_keys(a.mask, a.gt, a.lt, ak, sh.pmask, sh.pgt, sh.plt, sh.pk, sh.w2k, A.TW, A.K);
    sh.row_compat = compat_keys(conflict, ak, sh.pk, allow_wk, sh.well_known);
    const u64 collapse = collapse_keys(a.gt, a.lt, sh.pgt, sh.plt, A.K);
    u64 touched;
    sh.row_viable = topo_eval(a.mask, collapse, col, touched, sh.tout);
    sh.fcollapse = collapse;
    sh.ftouched = touched;
    sh.fother_m = ak.other & sh.pk.other & ~collapse;
    sh.fk.defined = ak.defined | sh.pk.defined | touched;
    sh.fk.other = sh.fother_m & ~touched;
  }
  __syncthreads();
  const u64 collapse = sh.fcollapse, touched = sh.ftouched, other_m = sh.fother_m;
  for (int w = tid; w < A.TW; w += NT) {
    const int key = sh.w2k[w];
    const bool keep = !((collapse >> key) & 1);
    const int am = a.mask[w], ax = a.exmask[w], pm = sh.pmask[w], px = sh.pex[w];
    unsigned m = keep ? (unsigned)(am & pm) : 0u;
    unsigned x = (keep && ((other_m >> key) & 1)) ? (unsigned)((ax & (pm | px)) | (px & (am | ax))) : 0u;
    if ((touched >> key) & 1) {
      unsigned tight = (unsigned)sh.full[w];
      for (int c = 0; c < A.C; ++c)
        if (is_v(sh.ckind[c]) && sh.ckid[c] == key) tight &= delta_word(c, w, a.mask, collapse, sh.tout);
      m &= tight;
      x = 0u;
    }
    sh.fmask[w] = (int)m;
    sh.fex[w] = (int)x;
  }
  for (int k = tid; k < A.K; k += NT) {
    sh.fgt[k] = max(a.gt[k], sh.pgt[k]);
    sh.flt[k] = min(a.lt[k], sh.plt[k]);
    sh.fminv[k] = max(a.minv[k], sh.pminv[k]);
  }
  __syncthreads();
  if (tid == 0) {
    const u64 segm = seg_nonzero(sh.fmask, sh.w2k, A.TW);
    const u64 segx = seg_nonzero(sh.fex, sh.w2k, A.TW);
    sh.fk.notin = sh.fk.other & segx;
    sh.fk.tol = sh.fk.notin | (~sh.fk.other & ~segm);
    sh.fsegm = segm;
    int has = 0;
    for (int k = 0; k < A.K; ++k) has |= sh.fminv[k] >= 0;
    sh.fhasminv = has;
  }
  __syncthreads();
}

// Surviving types of the working row (tpu_kernel.py _type_filter) into
// sh.fi; returns whether any survives. mode 0: the alive words of claim
// `arg`; mode 1: template `arg`'s members filtered by its pool limits;
// mode 2: template `arg`'s members as they are. sh.total holds the request
// total. All threads call.
__device__ bool type_filter(int mode, int arg) {
  const int tid = threadIdx.x;
  for (int w = tid; w < A.IW; w += NT) sh.offany[w] = 0u;
  __syncthreads();
  for (int o = tid; o < A.O; o += NT) {
    if (!U8(ovalid)[o]) continue;
    bool ok = true;
    for (int j = 0; j < 3; ++j) {
      const int w = I32(oword)[o * 3 + j];
      if (w >= 0 && !(((unsigned)sh.fmask[w] >> I32(obit)[o * 3 + j]) & 1u)) ok = false;
    }
    const int t = I32(otype)[o];
    if (ok && t >= 0 && t < A.I) atomicOr(&sh.offany[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
  bool any = false;
  const int R = A.R;
  for (int base = 0; base < A.IW * 32; base += NT) {
    const int i = base + tid;
    bool ok = false;
    if (i < A.I) {
      bool alive;
      if (mode == 0) {
        alive = ((unsigned)I32(alive)[(long long)arg * A.IW + (i >> 5)] >> (i & 31)) & 1u;
      } else {
        alive = ((unsigned)I32(ttypes)[arg * A.IW + (i >> 5)] >> (i & 31)) & 1u;
        if (mode == 1 && alive && U8(thas_limits)[arg]) {
          for (int r = 0; r < R; ++r)
            if (U8(tlimit_def)[arg * R + r] && I32(icap)[(long long)i * R + r] > I32(trem)[arg * R + r])
              alive = false;
        }
      }
      ok = alive && ((sh.offany[i >> 5] >> (i & 31)) & 1u);
      for (int r = 0; r < R && ok; ++r)
        if (sh.total[r] > I32(ialloc)[(long long)i * R + r]) ok = false;
      if (ok) {
        const Row ir = ROW(ireq, i);
        const RowKeys ik = row_keys(ir, sh.w2k, A.TW, A.K);
        ok = conflict_keys(ir.mask, ir.gt, ir.lt, ik, sh.fmask, sh.fgt, sh.flt, sh.fk, sh.w2k, A.TW,
                           A.K) == 0;
      }
    }
    const unsigned word = __ballot_sync(0xffffffffu, ok);
    if ((tid & 31) == 0 && (i >> 5) < A.IW) sh.fi[i >> 5] = word;
    any = any || word != 0u;
  }
  return __syncthreads_or(any);
}

// SatisfiesMinValues over the surviving types (tpu_kernel.py
// _min_values_ok). All threads call.
__device__ bool min_values_ok() {
  if (!sh.fhasminv) return true;
  const int tid = threadIdx.x;
  for (int w = tid; w < A.TW; w += NT) sh.uni[w] = 0u;
  __syncthreads();
  for (int i = tid; i < A.I; i += NT) {
    if (!((sh.fi[i >> 5] >> (i & 31)) & 1u)) continue;
    const Row ir = ROW(ireq, i);
    for (int w = 0; w < A.TW; ++w) {
      const int key = sh.w2k[w];
      if (!ir.defined[key]) continue;
      const unsigned src = (unsigned)(ir.other[key] ? ir.exmask[w] : ir.mask[w]);
      if (src) atomicOr(&sh.uni[w], src);
    }
  }
  __syncthreads();
  bool ok = true;
  if (tid == 0) {
    int counts[KTPU_MAX_K];
    for (int k = 0; k < A.K; ++k) counts[k] = 0;
    for (int w = 0; w < A.TW; ++w) counts[sh.w2k[w]] += __popc(sh.uni[w]);
    for (int k = 0; k < A.K; ++k)
      if (sh.fminv[k] >= 0 && counts[k] < sh.fminv[k]) ok = false;
  }
  return !__syncthreads_or(tid == 0 && !ok);
}

// node_filter.matches(final row) for one group's filter alternatives
__device__ bool eval_filter(const int* filt, bool allow_wk) {
  if (A.F == 0) return true;
  bool trivial = true, ok = false;
  for (int j = 0; j < A.FA; ++j) {
    const int alt = filt[j];
    if (alt >= 0) trivial = false;
    if (alt < 0) continue;
    const Row fr = ROW(freq, clampi(alt, 0, A.F - 1));
    const RowKeys fk = row_keys(fr, sh.w2k, A.TW, A.K);
    const u64 conflict =
        conflict_keys(sh.fmask, sh.fgt, sh.flt, sh.fk, fr.mask, fr.gt, fr.lt, fk, sh.w2k, A.TW, A.K);
    if (compat_keys(conflict, sh.fk, fk, allow_wk, sh.well_known)) ok = true;
  }
  return trivial || ok;
}

__device__ void write_row(const Row& dst) {
  const int tid = threadIdx.x;
  for (int w = tid; w < A.TW; w += NT) {
    ((int*)dst.mask)[w] = sh.fmask[w];
    ((int*)dst.exmask)[w] = sh.fex[w];
  }
  for (int k = tid; k < A.K; k += NT) {
    ((uint8_t*)dst.other)[k] = (sh.fk.other >> k) & 1;
    ((uint8_t*)dst.notin)[k] = (sh.fk.notin >> k) & 1;
    ((uint8_t*)dst.defined)[k] = (sh.fk.defined >> k) & 1;
    ((int*)dst.gt)[k] = sh.fgt[k];
    ((int*)dst.lt)[k] = sh.flt[k];
    ((int*)dst.minv)[k] = sh.fminv[k];
  }
}

// column max over the surviving types of `tab` [I, R] into sh.red
__device__ void surviving_max(const int* tab, int init) {
  const int tid = threadIdx.x;
  for (int r = tid; r < A.R; r += NT) sh.red[r] = init;
  __syncthreads();
  for (int i = tid; i < A.I; i += NT) {
    if (!((sh.fi[i >> 5] >> (i & 31)) & 1u)) continue;
    for (int r = 0; r < A.R; ++r) atomicMax(&sh.red[r], tab[(long long)i * A.R + r]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// candidate screens

__device__ bool screen_existing(int e) {
  const int R = A.R;
  if (!sh.ptol_e[e]) return false;
  for (int r = 0; r < R; ++r) {
    const int av = I32(eavail)[(long long)e * R + r];
    if (av < 0 || sh.preq[r] > av) return false;
  }
  for (int w = 0; w < A.HPW; ++w)
    if (sh.hp_conf[w] & I32(hp_used)[(long long)e * A.HPW + w]) return false;
  const Row a = ROW(ereq, e);
  const RowKeys ak = row_keys(a, sh.w2k, A.TW, A.K);
  const u64 conflict = conflict_keys(a.mask, a.gt, a.lt, ak, sh.pmask, sh.pgt, sh.plt, sh.pk, sh.w2k, A.TW, A.K);
  if (!compat_keys(conflict, ak, sh.pk, false, sh.well_known)) return false;
  const u64 collapse = collapse_keys(a.gt, a.lt, sh.pgt, sh.plt, A.K);
  u64 touched;
  TopoOut t;
  if (!topo_eval(a.mask, collapse, e, touched, t)) return false;
  return nonempty_ok(a.mask, collapse, t);
}


// Block-wide sum / min / max of one int per thread; all threads call and
// all get the result.
enum { RED_SUM = 0, RED_MIN = 1, RED_MAX = 2 };

__device__ __forceinline__ int red_op(int a, int b, int op) {
  return op == RED_SUM ? a + b : (op == RED_MIN ? min(a, b) : max(a, b));
}

__device__ int block_reduce(int v, int op) {
  for (int off = 16; off > 0; off >>= 1) v = red_op(v, __shfl_xor_sync(0xffffffffu, v, off), op);
  if ((threadIdx.x & 31) == 0) sh.bw[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = sh.bw[0];
  for (int w = 1; w < NWARP; ++w) r = red_op(r, sh.bw[w], op);
  __syncthreads();  // sh.bw is free again
  return r;
}

// ---------------------------------------------------------------------------
// the per-pod step

__device__ void stage_vocab() {
  const int tid = threadIdx.x;
  for (int w = tid; w < A.TW; w += NT) {
    sh.w2k[w] = I32(word2key)[w];
    sh.full[w] = I32(full_mask)[w];
  }
  if (tid == 0) sh.well_known = key_mask(U8(well_known), A.K);
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
  if (tid == 0) sh.pk = row_keys(pr.req, sh.w2k, TW, K);
  for (int c = tid; c < A.C; c += NT) {
    const int gv = clampi(sh.cgid[c], 0, A.Gv - 1);
    const long long base = (long long)gv * A.VMAX;
    sh.cgv[c] = gv;
    sh.ckid[c] = I32(v_kid)[gv];
    sh.cskew[c] = I32(v_skew)[gv];
    int mn = INF_I, nsup = 0;
    bool nonempty_total = false, any_compat = false;
    for (int v = 0; v < A.VMAX; ++v) {
      const bool reg = U8(v_reg)[base + v];
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
// selection, inverse and host-port rows), the nonempty hostname groups (from
// the current h_cnt), and its tier-0 rows as submitted; all threads call.
__device__ void stage_pod(int p) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = A.R;
  for (int r = tid; r < R; r += NT) sh.preq[r] = I32(prequests)[(long long)p * R + r];
  for (int g = tid; g < A.Gv; g += NT) sh.sel_v[g] = U8(sel_v)[(long long)p * A.Gv + g];
  for (int g = tid; g < A.Gh; g += NT) {
    sh.sel_h[g] = U8(sel_h)[(long long)p * A.Gh + g];
    sh.inv_h[g] = U8(inv_h)[(long long)p * A.Gh + g];
    sh.own_h[g] = U8(own_h)[(long long)p * A.Gh + g];
  }
  for (int w = tid; w < A.HPW; w += NT) {
    sh.hp_own[w] = I32(hp_own)[(long long)p * A.HPW + w];
    sh.hp_conf[w] = I32(hp_conf)[(long long)p * A.HPW + w];
  }
  for (int g = warp; g < A.Gh; g += NWARP) {
    bool any = false;
    for (int s = lane; s < A.S && !any; s += 32) any = I32(h_cnt)[(long long)g * A.S + s] > 0;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) sh.ne_h[g] = any;
  }
  if (tid == 0) {
    sh.valid = U8(valid)[p];
    sh.n_claims = *I32(n_claims);
  }
  stage_rows(pod_rows(p));
}

// The topology record (tpu_kernel.py _record) of the working row committed
// at global slot `slot_global`, for a pod with the given selection rows.
// Thread t owns groups t, t + NT, ..., so successive calls need no barrier
// between them as long as the working row stays put.
__device__ void record_row(int slot_global, bool allow_wk, const uint8_t* sel_v, const uint8_t* sel_h,
                           const uint8_t* own_h) {
  const int tid = threadIdx.x, K = A.K;
  for (int g = tid; g < A.Gv; g += NT) {
    const long long base = (long long)g * A.VMAX;
    const int kid = clampi(I32(v_kid)[g], 0, K - 1);
    const bool other_k = (sh.fk.other >> kid) & 1;
    int popc = 0;
    for (int v = 0; v < A.VMAX; ++v) {
      const int w = I32(v_word)[base + v];
      if (w >= 0 && (((unsigned)sh.fmask[w] >> I32(v_bit)[base + v]) & 1u)) ++popc;
    }
    const bool single = popc == 1 && !other_k;
    if (!(sel_v[g] && eval_filter(I32(v_filt) + (long long)g * A.FA, allow_wk))) continue;
    const bool anti = U8(v_anti)[g];
    for (int v = 0; v < A.VMAX; ++v) {
      const int w = I32(v_word)[base + v];
      if (w < 0) continue;
      const int b = I32(v_bit)[base + v];
      const bool seg = ((unsigned)sh.fmask[w] >> b) & 1u;
      const bool ex = ((unsigned)sh.fex[w] >> b) & 1u;
      const bool add = anti ? (other_k ? ex : seg) : (seg && single);
      if (add) I32(v_cnt)[base + v] += 1;
    }
  }
  for (int g = tid; g < A.Gh; g += NT) {
    const bool contrib =
        U8(h_inverse)[g] ? own_h[g] : (sel_h[g] && eval_filter(I32(h_filt) + (long long)g * A.FA, allow_wk));
    if (contrib && slot_global < A.S) I32(h_cnt)[(long long)g * A.S + slot_global] += 1;
  }
}

// The staged pod's exact decision and commit, after stage_pod (and, for a
// tier, stage_rows); all threads call and all get the result. Returns the
// output slot (-1 when the pod fails) and sets `kind` and `over` (a
// template fits but every claim slot is taken: nothing is committed).
__device__ int exact_step(int& kind, int& over) {
  const int tid = threadIdx.x;
  const int K = A.K, R = A.R, E = A.E, N = A.N, T = A.T, IW = A.IW;
  const bool valid = sh.valid;
  const int n_claims = sh.n_claims;
  int slot_e = 0, slot_c = 0, slot_t = 0;
  kind = KIND_FAIL;
  over = 0;

  if (valid) {
    // ---- 1. existing nodes, first candidate in fixed order ----
    if (E > 0) {
      int best = INT_MAX;
      for (int e = tid; e < E; e += NT)
        if (best == INT_MAX && screen_existing(e)) best = e;
      block_argmin(best, best);
      if (sh.best_key != INT_MAX) {
        kind = KIND_EXISTING;
        slot_e = sh.best_key;
        build_row(ROW(ereq, slot_e), slot_e, false);
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
        if (ok) {
          const Row a = ROW(creq, n);
          const RowKeys ak = row_keys(a, sh.w2k, A.TW, K);
          const u64 conflict =
              conflict_keys(a.mask, a.gt, a.lt, ak, sh.pmask, sh.pgt, sh.plt, sh.pk, sh.w2k, A.TW, K);
          ok = compat_keys(conflict, ak, sh.pk, true, sh.well_known);
          if (ok) {
            const u64 collapse = collapse_keys(a.gt, a.lt, sh.pgt, sh.plt, K);
            u64 touched;
            TopoOut t;
            ok = topo_eval(a.mask, collapse, E + n, touched, t) && nonempty_ok(a.mask, collapse, t);
          }
        }
        U8(cand)[n] = ok;
      }
      __syncthreads();
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
        const int n = sh.best_idx;
        if (n == INT_MAX) break;
        build_row(ROW(creq, n), E + n, true);
        for (int r = tid; r < R; r += NT) sh.total[r] = I32(crequests)[(long long)n * R + r] + sh.preq[r];
        __syncthreads();
        const bool ok = type_filter(0, n) && min_values_ok();
        if (ok) {
          kind = KIND_CLAIM;
          slot_c = n;
          break;
        }
        if (tid == 0) U8(cand)[n] = 0;
        __syncthreads();
      }
    }
    // ---- 4. new claim from the first viable template ----
    if (kind == KIND_FAIL) {
      for (int t = 0; t < T; ++t) {
        build_row(ROW(treq, t), -1, true);
        bool quick = false;
        if (tid == 0) {
          quick = sh.row_compat && sh.row_viable && (sh.ftouched & ~sh.fsegm) == 0 && sh.ptol_t[t];
          for (int w = 0; w < A.HPW && quick; ++w)
            if (sh.hp_conf[w] & I32(thp)[t * A.HPW + w]) quick = false;
        }
        if (!__syncthreads_or(quick)) continue;
        for (int r = tid; r < R; r += NT) sh.total[r] = I32(tdaemon)[t * R + r] + sh.preq[r];
        __syncthreads();
        if (type_filter(1, t) && min_values_ok()) {
          if (n_claims < N) {
            kind = KIND_NEW;
            slot_t = t;
          } else {
            over = 1;
          }
          break;
        }
      }
    }
  }

  // ---- 5. commit ----
  const int m = n_claims;
  int slot_global = 0;
  if (kind == KIND_EXISTING) {
    for (int r = tid; r < R; r += NT) I32(eavail)[(long long)slot_e * R + r] -= sh.preq[r];
    write_row(ROW(ereq, slot_e));
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
    write_row(ROW(creq, j));
    for (int r = tid; r < R; r += NT) I32(crequests)[(long long)j * R + r] += sh.preq[r];
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)j * IW + w] = (int)sh.fi[w];
    surviving_max(I32(ialloc), -INF_I);
    for (int r = tid; r < R; r += NT) I32(cmax_alloc)[(long long)j * R + r] = sh.red[r];
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
    write_row(ROW(creq, m));
    for (int r = tid; r < R; r += NT)
      I32(crequests)[(long long)m * R + r] = I32(tdaemon)[slot_t * R + r] + sh.preq[r];
    for (int w = tid; w < IW; w += NT) I32(alive)[(long long)m * IW + w] = (int)sh.fi[w];
    surviving_max(I32(ialloc), -INF_I);
    for (int r = tid; r < R; r += NT) I32(cmax_alloc)[(long long)m * R + r] = sh.red[r];
    __syncthreads();
    if (U8(thas_limits)[slot_t]) {
      // subtractMax on the template's pool limits
      surviving_max(I32(icap), 0);
      for (int r = tid; r < R; r += NT)
        if (U8(tlimit_def)[slot_t * R + r]) I32(trem)[slot_t * R + r] -= sh.red[r];
    }
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
      if (!((sh.fi[t >> 5] >> (t & 31)) & 1u)) continue;
      bool ok = true;
      for (int j = 0; j < 3; ++j) {
        const int w = I32(oword)[o * 3 + j];
        if (w >= 0 && !(((unsigned)sh.fmask[w] >> I32(obit)[o * 3 + j]) & 1u)) ok = false;
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
  }

  // topology record and host ports
  if (kind != KIND_FAIL) {
    record_row(slot_global, kind != KIND_EXISTING, sh.sel_v, sh.sel_h, sh.own_h);
    for (int w = tid; w < A.HPW; w += NT) {
      int add = sh.hp_own[w];
      if (kind == KIND_NEW) add |= I32(thp)[clampi(slot_t, 0, T > 0 ? T - 1 : 0) * A.HPW + w];
      I32(hp_used)[(long long)slot_global * A.HPW + w] |= add;
    }
  }
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
__device__ int relax_step(int p, int& kind, int& over, int& slot) {
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
    }
    slot = exact_step(kind, over);
    ++trips;
    if (kind != KIND_FAIL || over || !sh.valid) break;
  }
  return trips;
}

// The scan walk (tpu_kernel.py solve_scan): the batch's pods in order, each
// staged and taken through the exact step or, with relax, the tier loop;
// kinds and slots per pod, then the counter block's overflow and steps. K2
// walks it in its one CTA, K7 in each lane's CTA. All threads call.
__device__ __forceinline__ void scan_walk() {
  stage_vocab();
  int over_any = 0;
  for (int p = 0; p < A.P; ++p) {
    stage_pod(p);
    int kind, over, slot;
    if (A.relax) {
      const int trips = relax_step(p, kind, over, slot);
      if (threadIdx.x == 0) tier_tick(trips);
    } else {
      slot = exact_step(kind, over);
    }
    if (threadIdx.x == 0) {
      I32(kinds)[p] = kind;
      I32(slots)[p] = slot;
    }
    over_any |= over;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    I32(counters)[0] = over_any;
    I32(counters)[1] = A.P;
  }
}
