"""karpenter_tpu_torch — the provisioning solver on PyTorch and CUDA.

A port of `karpenter_tpu` to an NVIDIA Hopper card. The JAX package stays
the reference: every module here mirrors its counterpart's path, and the
tests hold the two against each other. This package imports `torch` and
never `jax` or `karpenter_tpu`; the pure-Python host modules (api,
scheduling, cloudprovider, encode, oracle) are kept as copies.

Layout:
  api/, utils/, scheduling/, cloudprovider/             host copies
  metrics.py, logging.py, events.py, options.py         host copies (options:
                                                        the card's crossover)
  testing/                                              fixtures (host copies and
                                                        underutilized_world)
  ops/vocab.py, ops/encode.py                           host encoding copies
  ops/kernels.py                                        requirement algebra
  device.py                                             device choice, bit words
  solver/tpu_kernel.py                                  the per-pod step (K2) and
                                                        its lane grid (K7)
  solver/tpu_runs.py                                    the run kernel (K3)
  solver/tpu.py                                         TorchScheduler (K1, K4, K5)
  solver/hybrid.py                                      TorchHybridScheduler and
                                                        solve_in_process: the
                                                        kernels, the oracle for
                                                        the rest
  solver/fleet.py, solver/epochs.py                     fleet lanes (K7 reading
                                                        each lane through a lane
                                                        table) and their window
                                                        key
  controllers/kube.py, state.py                         API store, cluster cache
                                                        (host copies)
  controllers/provisioning.py                           Batcher, VolumeTopology,
                                                        the Provisioner
  controllers/nodepool_aux.py                           the requirement validator
  controllers/static.py                                 the pools' node limit
  controllers/disruption/                               candidates, budgets, the
                                                        referee, sweep.py (K6,
                                                        K7), setsweep.py (K8),
                                                        the methods, Validator,
                                                        OrchestrationQueue and
                                                        DisruptionController
  csrc/, _build.py                                      CUDA sources, nvcc build
  wire.py, convert.py                                   request decode, reference
                                                        tensors and clusters ->
                                                        the port's
"""

__version__ = "0.1.0"
