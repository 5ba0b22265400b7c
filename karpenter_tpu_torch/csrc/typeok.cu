// K1 typeok_screen: the pod-class x instance-type pairwise screen.
//
// Replaces karpenter_tpu/solver/tpu.py:61 `_typeok_chunk_impl`: out[b, w]
// bit t is set when requirement class b intersects instance type w*32+t
// (Requirements.Intersects without the defined-key rule). Types at or past
// I give 0.
//
// Design: one warp per (class row, 32-type word). Lane t evaluates its
// type's conflict keys over the K keys, folding the TW words into 64-bit
// key masks; __ballot_sync packs the word directly, so no bit is ever
// summed. Bound on an H100: bytes (the type rows are read once per class
// row, ~ (2 TW + 5 K) * 4 bytes each); at the headline shape it is a few
// hundred KB, so launch latency dominates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "algebra.cuh"

using namespace ktpu;

struct TypeokArgs {
  const int* imask;
  const int* iexmask;
  const uint8_t* iother;
  const uint8_t* inotin;
  const uint8_t* idefined;
  const int* igt;
  const int* ilt;
  const int* iminv;
  const int* pmask;
  const int* pexmask;
  const uint8_t* pother;
  const uint8_t* pnotin;
  const uint8_t* pdefined;
  const int* pgt;
  const int* plt;
  const int* pminv;
  const int* word2key;
  int* out;
  int B, I, TW, K, IW;
};

__global__ void typeok_kernel(TypeokArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)a.B * a.IW) return;
  const int b = (int)(warp / a.IW);
  const int w = (int)(warp % a.IW);
  const int i = w * 32 + lane;
  bool ok = false;
  if (i < a.I) {
    const int TW = a.TW, K = a.K;
    Row ir{a.imask + (long long)i * TW, a.iexmask + (long long)i * TW, a.iother + (long long)i * K,
           a.inotin + (long long)i * K, a.idefined + (long long)i * K, a.igt + (long long)i * K,
           a.ilt + (long long)i * K, a.iminv + (long long)i * K};
    Row pr{a.pmask + (long long)b * TW, a.pexmask + (long long)b * TW, a.pother + (long long)b * K,
           a.pnotin + (long long)b * K, a.pdefined + (long long)b * K, a.pgt + (long long)b * K,
           a.plt + (long long)b * K, a.pminv + (long long)b * K};
    RowKeys ik = row_keys(ir, a.word2key, TW, K);
    RowKeys pk = row_keys(pr, a.word2key, TW, K);
    ok = conflict_keys(ir.mask, ir.gt, ir.lt, ik, pr.mask, pr.gt, pr.lt, pk, a.word2key, TW, K) == 0;
  }
  unsigned word = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) a.out[(long long)b * a.IW + w] = (int)word;
}

extern "C" int typeok_screen_launch(const TypeokArgs* args, void* stream) {
  TypeokArgs a = *args;
  long long warps = (long long)a.B * a.IW;
  if (warps == 0) return 0;
  const int threads = 256;
  long long blocks = (warps * 32 + threads - 1) / threads;
  typeok_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int typeok_args_size() { return (int)sizeof(TypeokArgs); }
