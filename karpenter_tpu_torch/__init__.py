"""karpenter_tpu_torch — the provisioning solver on PyTorch and CUDA.

A port of `karpenter_tpu` to an NVIDIA Hopper card. The JAX package stays
the reference: every module here mirrors its counterpart's path, and the
tests hold the two against each other. This package imports `torch` and
never `jax` or `karpenter_tpu`; the pure-Python host modules (api,
scheduling, cloudprovider, encode, oracle) are kept as copies.

Layout:
  api/, utils/, scheduling/, cloudprovider/             host copies
  cloudprovider/fake.py                                 the fake provider and
                                                        instance-type factories
  metrics.py, logging.py, events.py, options.py         host copies (options:
                                                        the card's crossover)
  tracing.py                                            solve traces, the trace
                                                        ring, the solve metrics
  analysis/protorec.py                                  the protocol recorder
  analysis/runtime.py, budgets.py                       launches, syncs, copies
                                                        and uploads per solve;
                                                        torch_budgets.json
  testing/fixtures.py                                   fixtures (host copies,
                                                        underutilized_world, the
                                                        runs-path stall case)
  testing/fuzz.py                                       the fuzz harness: seeded
                                                        cases, parity, invariants,
                                                        chaos, shrink, the corpus
  testing/faults.py                                     the fault proxy (stdlib)
  ops/vocab.py, ops/encode.py                           host encoding copies
  ops/kernels.py                                        requirement algebra
  device.py                                             device choice, bit words
  solver/tpu_kernel.py                                  the per-pod step (K2) and
                                                        its lane grid (K7)
  solver/tpu_runs.py                                    the run kernel (K3), its
                                                        retry and stall guard
  solver/tpu.py                                         TorchScheduler (K1, K4, K5)
  solver/hybrid.py                                      TorchHybridScheduler and
                                                        solve_in_process: the
                                                        kernels, the oracle for
                                                        the rest; CircuitBreaker
                                                        and ResilientSolver
  solver/fleet.py                                       fleet lanes (K7 reading
                                                        each lane through a lane
                                                        table)
  solver/epochs.py                                      fingerprints, epochs and
                                                        deltas, the table cache
                                                        on the card, admission
  solver/service.py                                     the sidecar: SolverServer,
                                                        SolverClient
  solver/aot.py                                         the prewarm over the
                                                        bucket ladder
  controllers/kube.py, state.py                         API store, cluster cache
                                                        (host copies)
  controllers/provisioning.py                           Batcher, VolumeTopology,
                                                        the Provisioner
  controllers/operator.py                               the Operator: every
                                                        controller a tick
  controllers/lifecycle.py, termination.py              claim launch to
                                                        initialization; the drain
  controllers/nodeclaim_aux.py                          disruption conditions,
                                                        expiration, GC, pod
                                                        events, consistency,
                                                        hydration
  controllers/nodepool_aux.py                           the NodePool hash,
                                                        counter, readiness,
                                                        validation; node repair
  controllers/static.py                                 static-capacity pools
  controllers/nodeoverlay.py                            price and capacity
                                                        overlays
  controllers/metrics_controllers.py, probes.py         gauges; the HTTP probes
  controllers/disruption/                               candidates, budgets, the
                                                        referee, sweep.py (K6,
                                                        K7), setsweep.py (K8),
                                                        the methods, Validator,
                                                        OrchestrationQueue and
                                                        DisruptionController
  csrc/, _build.py                                      CUDA sources, nvcc build
  wire.py, convert.py                                   the problem and result
                                                        codec; reference tensors
                                                        and clusters -> the
                                                        port's
"""

__version__ = "0.1.0"
