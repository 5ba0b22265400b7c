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
  /* the type tables the wrapper derives once per Tables (tpu_kernel.type_tables) */        \
  X(imask_t) X(bkeys) X(igt_t) X(ilt_t) X(ialloc_t) X(oclass) X(otypes)                     \
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
  X(seq) X(is_head) X(bulk) X(aff) X(run_rem) X(scratch)                                     \
  /* the per-phase clock breakdown (int64 [2 * KTPU_NPH + 2]; 0: off) */                     \
  X(prof)

// The fields K7 scan_lanes resolves per lane (step.cuh `FIELD`): the state,
// the pod batch, the outputs and the scratch block. The host hands one
// pointer per lane and field (a field the lanes share gets lane 0's
// pointer in every lane); every other pointer field is one table all lanes
// read.
#define KTPU_LANE_PTR_FIELDS(X)                                                              \
  X(active) X(count) X(rank) X(tmpl) KTPU_REQS_FIELDS(X, creq) X(crequests) X(alive)         \
  X(cmax_alloc) X(n_claims) KTPU_REQS_FIELDS(X, ereq) X(eavail) X(trem) X(v_cnt) X(h_cnt)    \
  X(rescap) X(held) X(hp_used)                                                               \
  KTPU_REQS_FIELDS(X, preq) X(prequests) X(typeok) X(tol_t) X(tol_e) X(topo_kind)            \
  X(topo_gid) X(topo_sel) X(sel_v) X(sel_h) X(inv_h) X(own_h) X(valid) X(hp_own) X(hp_conf)  \
  X(rrow) X(ntiers) X(kinds) X(slots) X(counters) X(cand) X(scratch)

#define KTPU_STEP_INT_FIELDS(X)                                                              \
  X(P) X(N) X(E) X(T) X(I) X(IW) X(TW) X(K) X(R) X(O) X(Gv) X(VMAX) X(Gh) X(GhS) X(S) X(C)   \
  X(F) X(FA) X(HPW) X(NRES) X(NRESW) X(n_valid) X(L) X(NRX) X(relax) X(NOC) X(NBK) X(SMB)

struct StepArgs {
#define KTPU_DECL_PTR(name) void* name;
  KTPU_STEP_PTR_FIELDS(KTPU_DECL_PTR)
#undef KTPU_DECL_PTR
#define KTPU_DECL_INT(name) int name;
  KTPU_STEP_INT_FIELDS(KTPU_DECL_INT)
#undef KTPU_DECL_INT
};

// NOC: offering classes in `oclass`; NBK: keys in `bkeys`; SMB: the shared-memory
// budget of the type tables: the wrapper passes a cap (tpu_kernel.SMEM_CAP,
// INT_MAX by default) and the launch function lowers it to what the card
// leaves (step.cuh step_smem).

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
// tier_steps, then the KTPU_TIER_BINS tier_hist bins, then the runs walk's
// stall counter (tpu_kernel.py N_COUNTERS)
#define KTPU_CNT_TIER_STEPS 5
#define KTPU_TIER_BINS 8
#define KTPU_CNT_STALL (KTPU_CNT_TIER_STEPS + 1 + KTPU_TIER_BINS)
// the run kernel's bulk window (tpu_runs.py W)
#define KTPU_RUN_W 64

// The phases of the per-phase clock breakdown (step.cuh prof_mark), in
// the order of the prof buffer: cycles of each phase, then the count of
// its entries, then the launch's total cycles and its globaltimer ns.
#define KTPU_PHASES(X)                                                                        \
  X(prologue) X(stage_pod) X(restage) X(seq_rank)                                            \
  X(cache_claims) X(cache_existing) X(cache_templates) X(bulk_screen)                        \
  X(existing_rows) X(existing_commit) X(level_select) X(level_rows) X(level_filter)          \
  X(level_commit) X(solo_rows) X(solo_filter) X(solo_commit) X(new_rows) X(new_filter)       \
  X(new_commit) X(existing_screen) X(claim_screen) X(verify_argmin) X(verify_build_row)      \
  X(verify_type_filter) X(verify_min_values) X(template_branch) X(commit_rank)               \
  X(commit_surviving_max) X(commit_reservations) X(commit_record) X(commit_other) X(other)

#define KTPU_PH_ENUM(name) PH_##name,
enum { KTPU_PHASES(KTPU_PH_ENUM) KTPU_NPH };
#undef KTPU_PH_ENUM
