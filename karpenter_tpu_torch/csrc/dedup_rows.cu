// K5 dedup_rows: the distinct rows of a [n, C] u32 matrix, each row's index
// among them, and their count.
//
// Replaces karpenter_tpu/solver/tpu.py:264 `_dedup_decode_state` (its
// device part: the claim rows packed side by side are built by the caller).
// The output equals the reference's bit for bit:
//   1. two wrapping u32 row hashes, h1 = sum_j row[j] * (2j+1) * 2654435761
//      and h2 = sum_j (row[j] + j) * (2j+1) * 2246822519: one warp a row,
//      exact in any order of summation;
//   2. the rows ordered by (h1, h2, row index), which is the reference's
//      stable jnp.lexsort((h2, h1)): a bitonic network over the 64-bit key
//      with the index as the last tie-break, padded to a power of two with
//      keys that sort last. Up to 8192 rows it runs in one CTA's shared
//      memory; above, one launch per pass over global memory;
//   3. each sorted row compared in full with its predecessor (a warp a
//      row): hash collisions only leave equal rows apart, never merge
//      distinct ones;
//   4. a one-CTA scan of the "new row" flags gives each sorted row its
//      unique index; inv[order[i]] and the unique rows (compact, zeroed by
//      the caller) are scattered, and n_uniq written.
//
// Bound on an H100: bytes (the rows read once, compact and inv written
// once: about 3 MB at the headline's n = 2048, C = 184); the sort's
// dependent passes and the launches decide in practice.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

typedef unsigned long long u64;

struct DedupArgs {
  const unsigned* rows;  // [n, C]
  unsigned* compact;     // [n, C], zeroed by the caller
  int* inv;              // [n]
  int* n_uniq;           // scalar
  u64* keys;             // [L] scratch
  int* order;            // [L] scratch
  int* flags;            // [n] scratch
  int n, C, L;           // L: n rounded up to a power of two
};

#define SHARED_SORT_MAX 8192
#define SCAN_NT 1024

__global__ void hash_kernel(DedupArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= a.L) return;
  if (i >= a.n) {
    if (lane == 0) {
      a.keys[i] = ~0ull;
      a.order[i] = INT_MAX;
    }
    return;
  }
  const unsigned* row = a.rows + (long long)i * a.C;
  unsigned h1 = 0u, h2 = 0u;
  for (int j = lane; j < a.C; j += 32) {
    const unsigned odd = 2u * (unsigned)j + 1u;
    h1 += row[j] * (odd * 2654435761u);
    h2 += (row[j] + (unsigned)j) * (odd * 2246822519u);
  }
  for (int off = 16; off > 0; off >>= 1) {
    h1 += __shfl_xor_sync(0xffffffffu, h1, off);
    h2 += __shfl_xor_sync(0xffffffffu, h2, off);
  }
  if (lane == 0) {
    a.keys[i] = ((u64)h1 << 32) | (u64)h2;
    a.order[i] = i;
  }
}

__device__ __forceinline__ bool key_less(u64 ka, int ia, u64 kb, int ib) { return ka < kb || (ka == kb && ia < ib); }

// the compare-exchange of bitonic stage (k, j) at element i (< i ^ j)
__device__ __forceinline__ void bitonic_cx(u64* keys, int* idx, int i, int j, int k) {
  const int l = i ^ j;
  const bool up = (i & k) == 0;
  const u64 ki = keys[i], kl = keys[l];
  const int ii = idx[i], il = idx[l];
  if (key_less(kl, il, ki, ii) == up) {
    keys[i] = kl;
    keys[l] = ki;
    idx[i] = il;
    idx[l] = ii;
  }
}

__global__ void sort_shared_kernel(DedupArgs a) {
  extern __shared__ u64 smem[];
  u64* keys = smem;
  int* idx = (int*)(smem + a.L);
  const int L = a.L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    keys[i] = a.keys[i];
    idx[i] = a.order[i];
  }
  __syncthreads();
  for (int k = 2; k <= L; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < L / 2; t += blockDim.x) bitonic_cx(keys, idx, 2 * j * (t / j) + (t % j), j, k);
      __syncthreads();
    }
  for (int i = threadIdx.x; i < L; i += blockDim.x) a.order[i] = idx[i];
}

__global__ void sort_pass_kernel(DedupArgs a, int j, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.L / 2) bitonic_cx(a.keys, a.order, 2 * j * (t / j) + (t % j), j, k);
}

__global__ void mark_kernel(DedupArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= a.n) return;
  bool differs = i == 0;
  if (i > 0) {
    const unsigned* r0 = a.rows + (long long)a.order[i - 1] * a.C;
    const unsigned* r1 = a.rows + (long long)a.order[i] * a.C;
    for (int j = lane; j < a.C && !differs; j += 32) differs = r0[j] != r1[j];
    differs = __any_sync(0xffffffffu, differs);
  }
  if (lane == 0) a.flags[i] = differs;
}

// flags (0/1) -> the unique index of each sorted row (inclusive sum - 1)
__global__ void __launch_bounds__(SCAN_NT, 1) scan_kernel(DedupArgs a) {
  __shared__ int part[SCAN_NT];
  const int tid = threadIdx.x, n = a.n;
  const int per = (n + SCAN_NT - 1) / SCAN_NT;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a.flags[i];
  part[tid] = sum;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int t = 0; t < SCAN_NT; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
  }
  __syncthreads();
  int run = part[tid];
  for (int i = lo; i < hi; ++i) {
    run += a.flags[i];
    a.flags[i] = run - 1;
    a.inv[a.order[i]] = run - 1;
  }
  if (hi == n && lo < hi) *a.n_uniq = run;
}

__global__ void compact_kernel(DedupArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= a.n) return;
  const int dest = a.flags[i];
  if (i > 0 && a.flags[i - 1] == dest) return;  // a repeat of the row before
  const unsigned* src = a.rows + (long long)a.order[i] * a.C;
  unsigned* dst = a.compact + (long long)dest * a.C;
  for (int j = lane; j < a.C; j += 32) dst[j] = src[j];
}

extern "C" int dedup_rows_args_size() { return (int)sizeof(DedupArgs); }

extern "C" int dedup_rows_launch(const DedupArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const DedupArgs a = *args;
  if (a.n <= 0 || a.L < a.n || (a.L & (a.L - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int warp_blocks_L = (a.L + 7) / 8, warp_blocks_n = (a.n + 7) / 8;  // 8 warps a block
  hash_kernel<<<warp_blocks_L, 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.L <= SHARED_SORT_MAX) {
    const size_t bytes = (size_t)a.L * (sizeof(u64) + sizeof(int));
    err = cudaFuncSetAttribute(sort_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    sort_shared_kernel<<<1, 1024, bytes, s>>>(a);
  } else {
    const int blocks = (a.L / 2 + 255) / 256;
    for (int k = 2; k <= a.L; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) sort_pass_kernel<<<blocks, 256, 0, s>>>(a, j, k);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mark_kernel<<<warp_blocks_n, 256, 0, s>>>(a);
  scan_kernel<<<1, SCAN_NT, 0, s>>>(a);
  compact_kernel<<<warp_blocks_n, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}
