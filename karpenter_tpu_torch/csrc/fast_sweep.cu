// K6 fast_sweep: the delta-state consolidation sweep over prefix or
// singleton lanes.
//
// Replaces karpenter_tpu/controllers/disruption/sweep.py:158
// `_fast_sweep_kernel` (the lane derivation) and, through sweep_core.cuh,
// :82 `_ffd_feasibility_core` with tpu_runs.py:185 `_build_cache`.
//
// Design. sweep_core.cuh's two launches; the lane kernel derives lane b's
// availability from the slots' candidate indices: prefix lane b removes
// the slots of candidates 0..b, singleton lane b only candidate b's. The
// host builds the lanes' class counts (prefix sums or single rows of the
// per-candidate counts) and passes them in `counts`.
//
// Bound on an H100: bytes (sweep_core.cuh).
#include "sweep_core.cuh"

__global__ void __launch_bounds__(NT, SWEEP_LANES_PER_SM) fast_sweep_lanes() {
  const int b = blockIdx.x, tid = threadIdx.x, C = SA.C;
  const LaneMem L = lane_mem(b);
  const bool singleton = SA.singleton;
  derive_avail(L, [&](int e) {
    const int j = SI32(cand_idx)[e];
    return singleton ? j == b : j <= b;
  });
  for (int c = tid; c < C; c += NT) L.cnt[c] = SI32(counts)[(long long)b * C + c];
  __syncthreads();
  lane_core(b, L);
}

KTPU_SWEEP_EXPORTS(fast_sweep, fast_sweep_lanes)

extern "C" int fast_sweep_launch(const StepArgs* args, const SweepArgs* sargs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  size_t lane_bytes = 0;
  const int err = sweep_begin((const void*)fast_sweep_lanes, args, sargs, s, &lane_bytes);
  if (err != 0) return err;
  fast_sweep_lanes<<<sargs->B, NT, lane_bytes, s>>>();
  return (int)cudaGetLastError();
}
