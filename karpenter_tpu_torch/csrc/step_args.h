// The argument block of the step kernels (scan_step, run_step), declared
// once.
//
// The Python wrapper (karpenter_tpu_torch/solver/tpu_kernel.py) reads the
// field names back through <kernel>_field_names() and builds its ctypes
// structure from them, so this list is the only place the layout is written
// down. Pointer fields come first (all void*, typed by the kernel), then int
// fields. A kernel ignores the fields it does not use; the wrapper passes 0
// there.
#pragma once

#define KTPU_REQS_FIELDS(X, p) \
  X(p##_mask) X(p##_exmask) X(p##_other) X(p##_notin) X(p##_defined) X(p##_gt) X(p##_lt) X(p##_minv)

#define KTPU_STEP_PTR_FIELDS(X)                                                              \
  /* vocab */                                                                                \
  X(word2key) X(well_known) X(full_mask)                                                     \
  /* tables */                                                                               \
  KTPU_REQS_FIELDS(X, treq) X(tdaemon) X(ttypes) X(tlimit_def) X(thas_limits)                \
  KTPU_REQS_FIELDS(X, ireq) X(ialloc) X(icap) X(otype) X(oword) X(obit) X(ovalid) X(orid)    \
  X(v_kid) X(v_word) X(v_bit) X(v_reg) X(v_skew) X(v_mindom) X(v_filt) X(v_anti)             \
  X(h_skew) X(h_filt) X(h_inverse) KTPU_REQS_FIELDS(X, freq) X(thp)                          \
  /* relaxation-tier tables [NRX, L, ...] (read only when relax is set) */                   \
  KTPU_REQS_FIELDS(X, rt_preq) X(rt_typeok) X(rt_tol_t) X(rt_tol_e) X(rt_kind) X(rt_gid)     \
  X(rt_sel)                                                                                  \
  /* state, updated in place */                                                              \
  X(active) X(count) X(rank) X(tmpl) KTPU_REQS_FIELDS(X, creq) X(crequests) X(alive)         \
  X(cmax_alloc) X(n_claims) KTPU_REQS_FIELDS(X, ereq) X(eavail) X(trem) X(v_cnt) X(h_cnt)    \
  X(rescap) X(held) X(hp_used)                                                               \
  /* the pod batch [P, ...] */                                                               \
  KTPU_REQS_FIELDS(X, preq) X(prequests) X(typeok) X(tol_t) X(tol_e) X(topo_kind)            \
  X(topo_gid) X(topo_sel) X(sel_v) X(sel_h) X(inv_h) X(own_h) X(valid) X(hp_own) X(hp_conf)  \
  X(rrow) X(ntiers)                                                                          \
  /* outputs and scratch; the counters block is laid out below */                           \
  X(kinds) X(slots) X(counters) X(cand)                                                      \
  /* the run kernel: claim event sequence, run driver arrays, run cache scratch */           \
  X(seq) X(is_head) X(bulk) X(aff) X(run_rem) X(scratch)

#define KTPU_STEP_INT_FIELDS(X)                                                              \
  X(P) X(N) X(E) X(T) X(I) X(IW) X(TW) X(K) X(R) X(O) X(Gv) X(VMAX) X(Gh) X(GhS) X(S) X(C)   \
  X(F) X(FA) X(HPW) X(NRES) X(NRESW) X(n_valid) X(L) X(NRX) X(relax)

struct StepArgs {
#define KTPU_DECL_PTR(name) void* name;
  KTPU_STEP_PTR_FIELDS(KTPU_DECL_PTR)
#undef KTPU_DECL_PTR
#define KTPU_DECL_INT(name) int name;
  KTPU_STEP_INT_FIELDS(KTPU_DECL_INT)
#undef KTPU_DECL_INT
};

// Limits of the kernel's shared-memory staging; the wrapper refuses larger
// problems before launching.
#define KTPU_MAX_TW 128
#define KTPU_MAX_K 64
#define KTPU_MAX_C 8
#define KTPU_MAX_IW 128
#define KTPU_MAX_R 32
#define KTPU_MAX_G 64
#define KTPU_MAX_HPW 32
#define KTPU_MAX_T 64
#define KTPU_MAX_NRESW 32
// the counter block: overflow, steps, bulk_steps, next_seq, ptr,
// tier_steps, then the KTPU_TIER_BINS tier_hist bins (tpu_kernel.py
// N_COUNTERS)
#define KTPU_CNT_TIER_STEPS 5
#define KTPU_TIER_BINS 8
// the run kernel's bulk window (tpu_runs.py W)
#define KTPU_RUN_W 64
