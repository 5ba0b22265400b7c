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
// rows (N x (2 TW words + 5 K)), so at the headline shape a pod moves some
// hundred KB that stay in the 50 MB L2; the real limit of this first
// version is the per-pod latency of a single CTA's barriers and
// reductions, which a later multi-CTA design attacks.
#include "step.cuh"

__global__ void __launch_bounds__(NT, 1) scan_step_kernel() { scan_walk(); }

#define KTPU_NAME(name) #name ","
static const char kFieldNames[] =
    KTPU_STEP_PTR_FIELDS(KTPU_NAME) "|" KTPU_STEP_INT_FIELDS(KTPU_NAME);
#undef KTPU_NAME

extern "C" const char* scan_step_field_names() { return kFieldNames; }

extern "C" int scan_step_args_size() { return (int)sizeof(StepArgs); }

extern "C" int scan_step_launch(const StepArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(A, args, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  scan_step_kernel<<<1, NT, 0, s>>>();
  return (int)cudaGetLastError();
}
