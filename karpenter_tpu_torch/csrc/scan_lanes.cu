// K7 scan_lanes: K2's scan walk over B independent lanes, one CTA each.
//
// Replaces karpenter_tpu/controllers/disruption/sweep.py:690-697, the
// `jax.vmap(solve_scan)` of `_prefix_feasibility_traced` (the full-state
// consolidation sweep), relax on and off.
//
// Design. The launch is <<<B, NT>>>; CTA b walks the shared pod batch over
// lane b's own copy of the State with lane b's valid row, through the same
// step as K2 (scan_walk in step.cuh). The host lays each per-lane field's B
// copies one after another and passes the per-field lane strides
// (LaneStrides); step.cuh's accessors add blockIdx.x strides under
// KTPU_LANE_GRID, so the argument block is not copied per lane and K2's
// and K3's libraries, built without the define, are unchanged.
//
// Bound on an H100: bytes (each lane reads its state rows and the shared
// tables once per pod, hundreds of KB per lane at 2000 nodes). The lanes run
// in parallel, one per SM; each is K2's dependent chain of barriers and
// block reductions, so a lane's walk time is what the launch takes. Each
// lane's CTA stages the type tables in its own shared memory (one CTA per
// SM: up to 132 lanes run at once, more queue) and keeps its key masks in
// its own slice of the scratch block (a lane stride, like the state's).
#define KTPU_LANE_GRID
#include "step.cuh"

__global__ void __launch_bounds__(NT, 1) scan_lanes_kernel() { scan_walk(); }

KTPU_STEP_EXPORTS(scan_lanes)

extern "C" int scan_lanes_strides_size() { return (int)sizeof(LaneStrides); }

// one lane's scratch block (the caller lays B of them one after another)
extern "C" long long scan_lanes_scratch_bytes(const StepArgs* args) {
  Carver c{nullptr, 0};
  KeyCache kc;
  return (long long)carve_key_cache(c, *args, kc);
}

extern "C" int scan_lanes_launch(const StepArgs* args, const LaneStrides* strides, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  StepArgs a = *args;
  size_t dyn = 0;
  const int code = step_smem((const void*)scan_lanes_kernel, a, 1, &dyn);
  if (code != 0) return code;
  cudaError_t err = cudaMemcpyToSymbolAsync(A, &a, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(LS, strides, sizeof(LaneStrides), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  scan_lanes_kernel<<<lanes, NT, dyn, s>>>();
  return (int)cudaGetLastError();
}
