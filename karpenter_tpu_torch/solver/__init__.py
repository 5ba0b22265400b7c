"""The scheduling core: the oracle copy and the torch solver.

- `oracle`, `topology`, `nodes`, `ordering`, `buckets`, `tpu_problem`:
  host copies of the reference package's modules.
- `tpu_kernel`: the per-pod step, plain and as a CUDA kernel.
- `tpu`: TorchScheduler, the solve driver.
- `fleet`: the batch window that lets concurrent scan-path solves share
  one lane launch per round; `epochs`: the fingerprints that key it.
"""
