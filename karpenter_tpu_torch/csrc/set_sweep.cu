// K8 set_sweep: the delta-state consolidation sweep over arbitrary removal
// sets, one membership row per lane.
//
// Replaces karpenter_tpu/controllers/disruption/setsweep.py:100
// `_set_sweep_kernel` and, through sweep_core.cuh, sweep.py:82
// `_ffd_feasibility_core` with tpu_runs.py:185 `_build_cache`.
//
// Design. sweep_core.cuh's two launches; the lane kernel derives lane b
// from its membership row M[b, :J]: a slot is removed when its candidate
// (slot_cand, clamped to [0, J] as JAX clamps the gather; J is the
// sentinel column that is never set) is a member, and the lane's class
// counts are base + M[b] @ P, summed exactly in int32 by thread c over the
// J candidates (torch has no CUDA int32 matmul, and a float product is no
// count).
//
// Bound on an H100: bytes (sweep_core.cuh); the membership rows and P add
// B x J + J x C words.
#include "sweep_core.cuh"

__global__ void __launch_bounds__(NT, 1) set_sweep_lanes() {
  const int b = blockIdx.x, tid = threadIdx.x, E = A.E, R = A.R, J = SA.J, C = SA.C;
  lane_prologue();
  const int* m = SI32(member) + (long long)b * J;
  int* av = SI32(avail) + (long long)b * E * R;
  for (int i = tid; i < E * R; i += NT) {
    const int j = clampi(SI32(slot_cand)[i / R], 0, J);
    const bool removed = j < J && m[j] > 0;
    av[i] = removed ? -1 : SI32(avail0)[i];
  }
  int* cnt = SI32(lane_counts) + (long long)b * C;
  for (int c = tid; c < C; c += NT) {
    int sum = SI32(base_counts)[c];
    for (int j = 0; j < J; ++j) sum += m[j] * SI32(percand)[(long long)j * C + c];
    cnt[c] = sum;
  }
  __syncthreads();
  lane_core(b, av, cnt);
}

KTPU_SWEEP_EXPORTS(set_sweep)

extern "C" int set_sweep_launch(const StepArgs* args, const SweepArgs* sargs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = sweep_begin(args, sargs, s);
  if (err != 0) return err;
  set_sweep_lanes<<<sargs->B, NT, SWEEP_LANE_SMEM, s>>>();
  return (int)cudaGetLastError();
}
