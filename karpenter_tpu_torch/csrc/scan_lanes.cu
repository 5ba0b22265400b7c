// K7 scan_lanes: K2's scan walk over B independent lanes, one CTA each.
//
// Replaces karpenter_tpu/controllers/disruption/sweep.py:690-697, the
// `jax.vmap(solve_scan)` of `_prefix_feasibility_traced` (the full-state
// consolidation sweep), and karpenter_tpu/solver/fleet.py:164 `fleet_fn`
// (the fleet's `vmap(solve_scan)`), relax on and off.
//
// Design. The launch is <<<B, NT>>>; CTA b walks lane b's pod batch over
// lane b's own copy of the State, through the same step as K2 (scan_walk in
// step.cuh). The host resolves each lane's pointers once per launch: for
// every field of KTPU_LANE_PTR_FIELDS (the state, the pod rows, the
// outputs, the scratch block) the address of lane b's row, lane 0's where
// the lanes share the field (the sweep's pod batch but for `valid`). They
// go into the constant table LP, a row of pointers a lane, and step.cuh's
// FIELD reads lane b's row there at a block-uniform address; the tables
// every lane shares are read from A exactly as K2 reads them. So a lane
// pays no per-access lane arithmetic, and K2's and K3's libraries, built
// without the define, are unchanged. LP holds KTPU_MAX_LANES rows (about 60
// KB of the 64 KB of constant memory); a wider launch runs as consecutive
// launches of that many lanes.
//
// Bound on an H100: bytes (each lane reads its state rows and the shared
// tables once per pod, hundreds of KB per lane at 2000 nodes). The lanes run
// in parallel, one per SM; each is K2's dependent chain of barriers and
// block reductions, so a lane's walk time is what the launch takes. Each
// lane's CTA stages the type tables in its own shared memory (one CTA per
// SM: up to 132 lanes run at once, more queue) and keeps its key masks in
// its own scratch block.
#define KTPU_LANE_GRID
#include "step.cuh"

__global__ void __launch_bounds__(NT, 1) scan_lanes_kernel() { scan_walk(); }

KTPU_STEP_EXPORTS(scan_lanes)

static const char kLaneFieldNames[] = KTPU_LANE_PTR_FIELDS(KTPU_STR_NAME);
extern "C" const char* scan_lanes_lane_field_names() { return kLaneFieldNames; }
extern "C" int scan_lanes_max_lanes() { return KTPU_MAX_LANES; }

// one lane's scratch block (the caller lays B of them one after another)
extern "C" long long scan_lanes_scratch_bytes(const StepArgs* args) {
  Carver c{nullptr, 0};
  KeyCache kc;
  return (long long)carve_key_cache(c, *args, kc);
}

// `lane_ptrs` is [lanes, KTPU_NLANE]: lane b's pointer to each lane field.
extern "C" int scan_lanes_launch(const StepArgs* args, void* const* lane_ptrs, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  StepArgs a = *args;
  size_t dyn = 0;
  const int code = step_smem((const void*)scan_lanes_kernel, a, 1, &dyn);
  if (code != 0) return code;
  cudaError_t err = cudaMemcpyToSymbolAsync(A, &a, sizeof(StepArgs), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < lanes; b0 += KTPU_MAX_LANES) {
    const int n = lanes - b0 < KTPU_MAX_LANES ? lanes - b0 : KTPU_MAX_LANES;
    err = cudaMemcpyToSymbolAsync(LP, lane_ptrs + (size_t)b0 * KTPU_NLANE, (size_t)n * KTPU_NLANE * sizeof(void*), 0,
                                  cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    scan_lanes_kernel<<<n, NT, dyn, s>>>();
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
