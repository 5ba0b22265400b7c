"""The scheduling core: the oracle copy and the torch solver.

- `oracle`, `topology`, `nodes`, `ordering`, `buckets`, `tpu_problem`:
  host copies of the reference package's modules.
- `tpu_kernel`: the per-pod step, plain and as a CUDA kernel.
- `tpu`: TorchScheduler, the solve driver.
- `hybrid`: TorchHybridScheduler and `solve_in_process`, the entry point
  that routes each pod to the kernels or the oracle.
- `fleet`: the batch window that lets concurrent scan-path solves share
  one lane launch per round.
- `epochs`: the fingerprints that key it, the epoch sections and deltas,
  `EpochStore`, `DeviceTableCache` (table sets on the card) and
  `AdmissionGate`.
- `service`: the sidecar — `SolverServer` and `SolverClient` over the
  wire protocol (the codec lives in `karpenter_tpu_torch.wire`);
  `hybrid` also carries `CircuitBreaker` and `ResilientSolver`, the
  control plane's side of it.
"""

from karpenter_tpu_torch.solver.hybrid import TorchHybridScheduler, solve_in_process

__all__ = ["TorchHybridScheduler", "solve_in_process"]
