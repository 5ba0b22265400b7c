// K4 run_arrays: the run driver arrays of a requeue round.
//
// Replaces karpenter_tpu/solver/tpu.py:155 `_run_arrays`: from the round's
// pod index array and the per-class flags, is_head (first pod of its class
// run; padding positions are all heads), bulk and aff (the class flags,
// off for padding) and run_rem (pods from i to the end of its run).
//
// Design. One CTA of NT threads, each owning a contiguous chunk of the P
// positions: head flags and the chunk's minimum head position, a suffix
// minimum over the chunk minima (one thread; NT values), then each thread
// walks its chunk backwards carrying the next head after i. run_rem[i] =
// min(next head, P) - i, the reference's reverse cummin.
//
// Bound on an H100: bytes (a few [P] arrays, tens of KB at the headline's
// P = 16384), so the single launch's latency decides.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NT 1024

struct RunArraysArgs {
  const int* cls;          // [NCLS] class of each pod
  const uint8_t* bulk_c;   // [NC]
  const uint8_t* aff_c;    // [NC]
  const int* idx;          // [P] pod of each position
  uint8_t* is_head;        // [P]
  uint8_t* bulk;           // [P]
  uint8_t* aff;            // [P]
  int* run_rem;            // [P]
  int P, n, NCLS, NC;
};

__device__ __forceinline__ int class_at(const RunArraysArgs& a, int i) {
  const int pod = min(max(a.idx[i], 0), a.NCLS - 1);
  return min(max(a.cls[pod], 0), a.NC - 1);
}

__global__ void __launch_bounds__(NT, 1) run_arrays_kernel(RunArraysArgs a) {
  __shared__ int chunk_min[NT];
  const int tid = threadIdx.x, P = a.P;
  const int per = (P + NT - 1) / NT;
  const int lo = min(tid * per, P), hi = min(lo + per, P);
  int mn = INT_MAX;
  for (int i = lo; i < hi; ++i) {
    const int ci = class_at(a, i);
    const bool valid = i < a.n;
    // position 0 compares with the last position (jnp.roll) but is a head anyway
    const bool head = i == 0 || !valid || ci != class_at(a, i - 1);
    a.is_head[i] = head;
    a.bulk[i] = a.bulk_c[ci] && valid;
    a.aff[i] = a.aff_c[ci] && valid;
    if (head) mn = min(mn, i);
  }
  chunk_min[tid] = mn;
  __syncthreads();
  if (tid == 0) {
    // chunk_min[t] becomes the first head after chunk t
    int after = INT_MAX;
    for (int t = NT - 1; t >= 0; --t) {
      const int m = chunk_min[t];
      chunk_min[t] = after;
      after = min(after, m);
    }
  }
  __syncthreads();
  int next = chunk_min[tid];
  for (int i = hi - 1; i >= lo; --i) {
    a.run_rem[i] = min(next, P) - i;
    if (a.is_head[i]) next = i;
  }
}

extern "C" int run_arrays_args_size() { return (int)sizeof(RunArraysArgs); }

extern "C" int run_arrays_launch(const RunArraysArgs* args, void* stream) {
  if (args->P <= 0) return 0;
  run_arrays_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
