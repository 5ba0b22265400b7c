// K2 scan_step: the exact per-pod FFD step (step.cuh), walked over a whole
// pod batch in one launch.
//
// Replaces karpenter_tpu/solver/tpu_kernel.py:931 `solve_scan`, relax on
// and off (the step itself, :560 `_step`, and the tier loop, :898
// `_step_relax`, are step.cuh).
//
// Design. One CTA of NT threads walks the pods in order (scan_walk in
// step.cuh); per pod it stages the pod (stage_pod) and runs the shared step
// (exact_step, or with relax the tier loop relax_step around it), which
// updates the state in device memory in place. With relax == 0 the walk is
// the plain exact step and the tier counters stay 0.
//
// Bound on an H100: bytes. Per pod the claim screen reads the live claim
// rows' cached key masks (and the words of the keys that can conflict), so
// at the headline shape a pod moves some tens of KB that stay in the 50 MB
// L2; the real limit is the per-pod latency of a single CTA's barriers and
// dependent loads (step.cuh says what the design does about it). The
// scratch block holds the claim slots' and existing nodes' key masks.
#include "step.cuh"

__global__ void __launch_bounds__(NT, 1) scan_step_kernel() { scan_walk(); }

KTPU_STEP_EXPORTS(scan_step)

extern "C" long long scan_step_scratch_bytes(const StepArgs* args) {
  Carver c{nullptr, 0};
  KeyCache kc;
  return (long long)carve_key_cache(c, *args, kc);
}

extern "C" int scan_step_launch(const StepArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  StepArgs a = *args;
  size_t dyn = 0;
  const int err = step_smem((const void*)scan_step_kernel, a, 1, &dyn);
  if (err != 0) return err;
  const cudaError_t e = cudaMemcpyToSymbolAsync(A, &a, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  scan_step_kernel<<<1, NT, dyn, s>>>();
  return (int)cudaGetLastError();
}
