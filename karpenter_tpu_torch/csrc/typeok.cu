// K1 typeok_screen: the pod-class x instance-type pairwise screen.
//
// Replaces karpenter_tpu/solver/tpu.py:61 `_typeok_chunk_impl` (and its
// tier rows, :982): out[b, w] bit t is set when requirement class b
// intersects instance type w*32+t (Requirements.Intersects without the
// defined-key rule). Types at or past I give 0.
//
// Bound on an H100: bytes (each type row and class row read once, about
// (TW + 5 K) * 4 bytes a row: a few hundred KB at the headline's shape), so
// the launch's latency decides: the number of dependent trips to memory
// and of barriers a CTA waits for, not the arithmetic.
//
// Design. A CTA of NT threads takes one 32-type word of the output
// (blockIdx.x) and a chunk of `rb` <= 8 class rows (blockIdx.y), one warp a
// row, so the grid has IW x ceil(B / rb) CTAs (`typeok_tiling` in
// solver/tpu.py). The callers hand it their distinct rows only. The type flag rows must start on a 4-byte boundary (the
// wrapper sees to it).
//   1. Staging, one trip to memory: every thread starts its share of the
//      CTA's copies into shared memory with cp.async, with no register in
//      between: the 32 types' mask words (in stages of `cw` words when TW
//      is wider than the shared memory allows), bounds and flag bytes, the
//      rows' mask words and bounds and the words' keys; a warp a type or
//      row, its lanes over the words, so that neighbouring threads read
//      neighbouring words. The types' words and bounds land word-major with
//      a stride of 33, so that lane t later reads type t's without a bank
//      conflict. A warp's own row's flag bytes come to registers beside.
//   2. Once for the CTA, spread over the warps (four types a warp): each
//      type's nonzero keys (lanes over the words, one OR-reduction) and its
//      key masks (__ballot_sync over the keys) give (other, defined,
//      tolerance), the NotIn/DoesNotExist tolerance folded in; each warp
//      does the same for its row.
//   3. The pair test from shared memory: lane t of warp r folds the mask
//      words of type t and row r into the per-key intersection, then the K
//      bounds; __ballot_sync packs the word, so no bit is ever summed.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

struct TypeokTypes {  // the instance types: built once per type table by the wrapper
  const int* mask;        // [I, TW]
  const uint8_t* other;   // [I, K]
  const uint8_t* notin;   // [I, K]
  const uint8_t* defined; // [I, K]
  const int* gt;          // [I, K]
  const int* lt;          // [I, K]
  const int* word2key;    // [TW]
  int I, TW, K;
};

struct TypeokRows {  // the class rows of one call
  const int* mask;        // [B, TW]
  const uint8_t* other;   // [B, K]
  const uint8_t* notin;
  const uint8_t* defined;
  const int* gt;          // [B, K]
  const int* lt;
  int* out;               // [B, IW]
  int B, IW;
  int rb, cw;             // rows a CTA (<= NWARPS), mask words a stage
};

#define NT 256
#define NWARPS (NT / 32)
#define TYPES_A_WARP (32 / NWARPS)
#define TSTRIDE 33  // a staged type column: 32 types and one word of padding

// Dynamic shared memory of one CTA; solver/tpu.py `_typeok_smem` mirrors it.
__host__ __device__ inline size_t typeok_smem(int rb, int cw, int K) {
  return 3 * 32 * sizeof(u64) + sizeof(int) * ((size_t)cw * (TSTRIDE + rb + 1) + (size_t)K * (2 * TSTRIDE + 2 * rb)) +
         3 * 32 * (size_t)K;
}

// one 4-byte copy from device to shared memory, asynchronous (sm_80+)
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ u64 or_lanes(u64 v) {
  return (u64)__reduce_or_sync(0xffffffffu, (unsigned)v) | (u64)__reduce_or_sync(0xffffffffu, (unsigned)(v >> 32)) << 32;
}

// the keys k < K whose flag f[k] is set, as every lane of the warp sees it
__device__ __forceinline__ u64 flag_keys(const uint8_t* f, int K, int lane) {
  const unsigned lo = __ballot_sync(0xffffffffu, lane < K && f[lane]);
  const unsigned hi = __ballot_sync(0xffffffffu, lane + 32 < K && f[lane + 32]);
  return (u64)lo | (u64)hi << 32;
}

// copies of a stage's mask words and their keys, [w0, w0 + nw)
__device__ __forceinline__ void stage_masks(const TypeokTypes& T, const TypeokRows& R, unsigned* tm, unsigned* pm,
                                            int* w2k, int i0, int b0, int ntypes, int nrows, int w0, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < TYPES_A_WARP; ++j) {
    const int t = warp + NWARPS * j;
    for (int w = lane; w < nw; w += 32) {
      if (t < ntypes)
        copy4(tm + w * TSTRIDE + t, T.mask + (long long)(i0 + t) * T.TW + w0 + w);
      else
        tm[w * TSTRIDE + t] = 0u;
    }
  }
  if (warp < nrows)
    for (int w = lane; w < nw; w += 32) copy4(pm + warp * R.cw + w, R.mask + (long long)(b0 + warp) * T.TW + w0 + w);
  for (int w = threadIdx.x; w < nw; w += NT) copy4(w2k + w, T.word2key + w0 + w);
}

__global__ void __launch_bounds__(NT) typeok_kernel(const TypeokTypes T, const TypeokRows R) {
  extern __shared__ u64 smem[];
  // phase cut: entry (tools/typeok_phases.py returns here)
  const int rb = R.rb, cw = R.cw, K = T.K, TW = T.TW;
  u64* tkeys = smem;                       // [3][32]: other, defined, tolerance
  unsigned* tm = (unsigned*)(tkeys + 96);  // [cw][33]
  unsigned* pm = tm + cw * TSTRIDE;        // [rb][cw]
  int* w2k = (int*)(pm + rb * cw);         // [cw]
  int* tgt = w2k + cw;                     // [K][33]
  int* tlt = tgt + K * TSTRIDE;            // [K][33]
  int* pgt = tlt + K * TSTRIDE;            // [rb][K]
  int* plt = pgt + rb * K;                 // [rb][K]
  uint8_t* tflag = (uint8_t*)(plt + rb * K);  // [3][32 K]: other, notin, defined

  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int wt = blockIdx.x, i0 = wt * 32;
  const int b0 = blockIdx.y * rb;
  const int ntypes = min(32, T.I - i0);  // may be <= 0 past the last type
  const int nrows = min(rb, R.B - b0);
  const bool row_live = r < nrows;
  const long long brow = (long long)(b0 + r) * K;

  // 1. staging: the copies, then the row's flag bytes to registers
  const int fbytes = max(ntypes, 0) * K;  // the tile's flag bytes in each array
  const uint8_t* fsrc[3] = {T.other, T.notin, T.defined};
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const uint8_t* src = fsrc[f] + (long long)i0 * K;
    for (int e = threadIdx.x; 4 * e < fbytes; e += NT) {
      if (4 * e + 4 <= fbytes) {
        copy4(tflag + f * 32 * K + 4 * e, src + 4 * e);
      } else {  // the last, partial word: bytes past the array are not read
        for (int q = 4 * e; q < fbytes; ++q) tflag[f * 32 * K + q] = src[q];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TYPES_A_WARP; ++j) {
    const int t = r + NWARPS * j;
    for (int k = lane; k < K; k += 32) {
      if (t < ntypes) {
        const long long g = (long long)(i0 + t) * K + k;
        copy4(tgt + k * TSTRIDE + t, T.gt + g);
        copy4(tlt + k * TSTRIDE + t, T.lt + g);
      } else {
        tgt[k * TSTRIDE + t] = 0;
        tlt[k * TSTRIDE + t] = 0;
      }
    }
  }
  if (row_live)
    for (int k = lane; k < K; k += 32) {
      copy4(pgt + r * K + k, R.gt + brow + k);
      copy4(plt + r * K + k, R.lt + brow + k);
    }
  stage_masks(T, R, tm, pm, w2k, i0, b0, ntypes, nrows, 0, min(cw, TW));
  u64 po = 0, pn = 0, pd = 0;
  if (row_live) {
    po = flag_keys(R.other + brow, K, lane);
    pn = flag_keys(R.notin + brow, K, lane);
    pd = flag_keys(R.defined + brow, K, lane);
  }
  copies_done();
  __syncthreads();

  // phase cut: staged (tools/typeok_phases.py returns here)
  // 2-3. the mask words, a stage of cw words at a time (one stage when TW
  // fits): the nonzero keys of the warp's four types and of its row (lanes
  // over the words), and the pair intersection (lanes over the types)
  u64 tnz[TYPES_A_WARP] = {}, pnz = 0, seg = 0;
  for (int w0 = 0;; w0 += cw) {
    const int nw = max(0, min(cw, TW - w0));
    for (int w = lane; w < nw; w += 32) {
      const int k = w2k[w];
#pragma unroll
      for (int j = 0; j < TYPES_A_WARP; ++j) tnz[j] |= (u64)(tm[w * TSTRIDE + r + NWARPS * j] != 0) << k;
      if (row_live) pnz |= (u64)(pm[r * cw + w] != 0) << k;
    }
    if (row_live) {
#pragma unroll 4
      for (int w = 0; w < nw; ++w) seg |= (u64)((tm[w * TSTRIDE + lane] & pm[r * cw + w]) != 0) << w2k[w];
    }
    if (w0 + cw >= TW) break;
    __syncthreads();  // the stage is consumed before the next overwrites it
    stage_masks(T, R, tm, pm, w2k, i0, b0, ntypes, nrows, w0 + cw, min(cw, TW - w0 - cw));
    copies_done();
    __syncthreads();
  }

  // phase cut: stages (tools/typeok_phases.py returns here)
  // 2. the key masks, once for the CTA: the warp's four types to shared
  // memory, its row's kept
#pragma unroll
  for (int j = 0; j < TYPES_A_WARP; ++j) {
    const int t = r + NWARPS * j;
    const bool in = t < ntypes;
    const uint8_t* f = tflag + t * K;
    const u64 o = flag_keys(f, in ? K : 0, lane), ni = flag_keys(f + 32 * K, in ? K : 0, lane);
    const u64 d = flag_keys(f + 64 * K, in ? K : 0, lane), nz = or_lanes(tnz[j]);
    if (lane == 0) {
      tkeys[t] = o;
      tkeys[32 + t] = d;
      tkeys[64 + t] = ni | (~o & ~nz);
    }
  }
  const u64 ptol = pn | (~po & ~or_lanes(pnz));

  // phase cut: keys (tools/typeok_phases.py returns here)
  // 3. the bounds of (type lane, row r)
  u64 bounds = 0;
  if (row_live) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int gt = max(tgt[k * TSTRIDE + lane], pgt[r * K + k]);
      const int lt = min(tlt[k * TSTRIDE + lane], plt[r * K + k]);
      bounds |= (u64)(gt < lt) << k;
    }
  }
  // phase cut: bounds (tools/typeok_phases.py returns here)
  __syncthreads();  // the types' key masks
  if (!row_live) return;  // no barrier follows
  const u64 to = tkeys[lane], td = tkeys[32 + lane], ttol = tkeys[64 + lane];
  const u64 nonempty = seg | (to & po & bounds);
  const u64 low = K >= 64 ? ~0ull : ((1ull << K) - 1);
  const u64 conflict = td & pd & ~nonempty & ~(ttol & ptol) & low;
  const unsigned word = __ballot_sync(0xffffffffu, lane < ntypes && conflict == 0);
  if (lane == 0) R.out[(long long)(b0 + r) * R.IW + wt] = (int)word;
}

extern "C" size_t typeok_smem_bytes(int rb, int cw, int K) { return typeok_smem(rb, cw, K); }

extern "C" int typeok_screen_launch(const TypeokTypes* types, const TypeokRows* rows, void* stream) {
  const TypeokTypes T = *types;
  const TypeokRows R = *rows;
  if (R.B == 0 || R.IW == 0) return 0;
  if (R.rb < 1 || R.rb > NWARPS || R.cw < 1 || T.K < 0 || T.K > 64 ||
      (long long)R.IW * 32 < T.I)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)R.B + R.rb - 1) / R.rb;
  const size_t bytes = typeok_smem(R.rb, R.cw, T.K);
  if (chunks > 65535 || bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)T.other | (uintptr_t)T.notin | (uintptr_t)T.defined) & 3) return (int)cudaErrorMisalignedAddress;
  typeok_kernel<<<dim3((unsigned)R.IW, (unsigned)chunks), NT, bytes, (cudaStream_t)stream>>>(T, R);
  return (int)cudaGetLastError();
}

extern "C" int typeok_types_size() { return (int)sizeof(TypeokTypes); }
extern "C" int typeok_rows_size() { return (int)sizeof(TypeokRows); }
