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

__global__ void __launch_bounds__(NT, 1) fast_sweep_lanes() {
  const int b = blockIdx.x, tid = threadIdx.x, E = A.E, R = A.R;
  lane_prologue();
  int* av = SI32(avail) + (long long)b * E * R;
  for (int i = tid; i < E * R; i += NT) {
    const int j = SI32(cand_idx)[i / R];
    const bool removed = SA.singleton ? j == b : j <= b;
    av[i] = removed ? -1 : SI32(avail0)[i];
  }
  __syncthreads();
  lane_core(b, av, SI32(counts) + (long long)b * SA.C);
}

KTPU_SWEEP_EXPORTS(fast_sweep)

extern "C" int fast_sweep_launch(const StepArgs* args, const SweepArgs* sargs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = sweep_begin(args, sargs, s);
  if (err != 0) return err;
  fast_sweep_lanes<<<sargs->B, NT, SWEEP_LANE_SMEM, s>>>();
  return (int)cudaGetLastError();
}
