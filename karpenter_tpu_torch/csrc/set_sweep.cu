// K8 set_sweep: the delta-state consolidation sweep over arbitrary removal
// sets, one membership row per lane.
//
// Replaces karpenter_tpu/controllers/disruption/setsweep.py:100
// `_set_sweep_kernel` and, through sweep_core.cuh, sweep.py:82
// `_ffd_feasibility_core` with tpu_runs.py:185 `_build_cache`.
//
// Design. sweep_core.cuh's two launches; the lane kernel copies lane b's
// membership row M[b, :J] to shared memory and derives the lane from it:
// a slot is removed when its candidate (slot_cand, clamped to [0, J] as
// JAX clamps the gather; J is the sentinel column that is never set) is a
// member, and the lane's class counts are base + M[b] @ P, exact in int32:
// each thread sums its candidates' rows, the warps reduce by shuffles and
// thread c adds the warps' partials of class c (torch has no CUDA int32
// matmul, and a float product is no count).
//
// Bound on an H100: bytes (sweep_core.cuh); the membership rows and P add
// B x J + J x C words.
#include "sweep_core.cuh"

__global__ void __launch_bounds__(NT, SWEEP_LANES_PER_SM) set_sweep_lanes() {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, J = SA.J, C = SA.C;
  const LaneMem L = lane_mem(b);
  const int* m = SI32(member) + (long long)b * J;
  for (int j = tid; j < J; j += NT) L.m[j] = m[j];
  __syncthreads();
  derive_avail(L, [&](int e) {
    const int j = clampi(SI32(slot_cand)[e], 0, J);
    return j < J && L.m[j] > 0;
  });
  for (int c = 0; c < C; ++c) {
    int part = 0;
    for (int j = tid; j < J; j += NT) part += L.m[j] * SI32(percand)[(long long)j * C + c];
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL_MASK, part, off);
    if (lane == 0) L.part[c * NWARP + warp] = part;
  }
  __syncthreads();
  for (int c = tid; c < C; c += NT) {
    int sum = SI32(base_counts)[c];
    for (int w = 0; w < NWARP; ++w) sum += L.part[c * NWARP + w];
    L.cnt[c] = sum;
  }
  __syncthreads();
  lane_core(b, L);
}

KTPU_SWEEP_EXPORTS(set_sweep, set_sweep_lanes)

extern "C" int set_sweep_launch(const StepArgs* args, const SweepArgs* sargs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  size_t lane_bytes = 0;
  const int err = sweep_begin((const void*)set_sweep_lanes, args, sargs, s, &lane_bytes);
  if (err != 0) return err;
  set_sweep_lanes<<<sargs->B, NT, lane_bytes, s>>>();
  return (int)cudaGetLastError();
}
