// The requirement algebra (ops/kernels.py) as __device__ functions.
//
// A requirement row is the Reqs encoding: mask/exmask are [TW] 32-bit
// words (carried as int32, used as uint32 here), other/notin/defined are
// [K] bytes, gt/lt/minv are [K] int32. Per-key flags are folded into 64-bit
// key masks (bit k = key k), so every per-key any/all of the reference is a
// word operation; the wrappers refuse K > 64.
#pragma once
#include <stdint.h>

typedef unsigned long long u64;

namespace ktpu {

struct Row {  // one requirement row in device memory
  const int* mask;
  const int* exmask;
  const uint8_t* other;
  const uint8_t* notin;
  const uint8_t* defined;
  const int* gt;
  const int* lt;
  const int* minv;
};

__device__ __forceinline__ u64 kbit(int k) { return 1ull << k; }

__device__ __forceinline__ u64 key_mask(const uint8_t* flags, int K) {
  u64 m = 0;
  for (int k = 0; k < K; ++k)
    if (flags[k]) m |= kbit(k);
  return m;
}

// seg_any(mask != 0) as a key mask.
__device__ __forceinline__ u64 seg_nonzero(const int* mask, const int* w2k, int TW) {
  u64 m = 0;
  for (int w = 0; w < TW; ++w)
    if (mask[w] != 0) m |= kbit(w2k[w]);
  return m;
}

// Per-row key masks the algebra needs: other, notin, defined and the
// NotIn/DoesNotExist tolerance (notin | (~other & ~seg_any(mask != 0))).
struct RowKeys {
  u64 other, notin, defined, tol;
};

__device__ __forceinline__ RowKeys row_keys(const Row& r, const int* w2k, int TW, int K) {
  RowKeys o;
  o.other = key_mask(r.other, K);
  o.notin = key_mask(r.notin, K);
  o.defined = key_mask(r.defined, K);
  o.tol = o.notin | (~o.other & ~seg_nonzero(r.mask, w2k, TW));
  return o;
}

__device__ __forceinline__ u64 low_keys(int K) { return K >= 64 ? ~0ull : (kbit(K) - 1); }

// Conflicting keys of _conflict(a, b): shared defined keys whose allowed
// sets do not intersect, minus the tolerance when both sides tolerate.
// bmask/bgt/blt/bk describe b (often a row staged in shared memory).
__device__ __forceinline__ u64 conflict_keys(const int* amask, const int* agt, const int* alt,
                                             const RowKeys& ak, const int* bmask, const int* bgt,
                                             const int* blt, const RowKeys& bk, const int* w2k,
                                             int TW, int K) {
  u64 seg = 0;
  for (int w = 0; w < TW; ++w)
    if ((amask[w] & bmask[w]) != 0) seg |= kbit(w2k[w]);
  u64 bounds = 0;
  for (int k = 0; k < K; ++k) {
    int gt = max(agt[k], bgt[k]);
    int lt = min(alt[k], blt[k]);
    if (gt < lt) bounds |= kbit(k);
  }
  u64 nonempty = seg | (ak.other & bk.other & bounds);
  return ak.defined & bk.defined & ~nonempty & ~(ak.tol & bk.tol) & low_keys(K);
}

// Requirements.Compatible(a, b): no conflict and every key b defines is
// defined by a (or tolerated by b, or well-known when allowed).
__device__ __forceinline__ bool compat_keys(u64 conflict, const RowKeys& ak, const RowKeys& bk,
                                            bool allow_wk, u64 well_known) {
  u64 def_fail = bk.defined & ~ak.defined & ~bk.tol;
  if (allow_wk) def_fail &= ~well_known;
  return (conflict | def_fail) == 0;
}

__device__ __forceinline__ unsigned popc32(int x) { return __popc((unsigned)x); }

}  // namespace ktpu
