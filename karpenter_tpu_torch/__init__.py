"""karpenter_tpu_torch — the provisioning solver on PyTorch and CUDA.

A port of `karpenter_tpu` to an NVIDIA Hopper card. The JAX package stays
the reference: every module here mirrors its counterpart's path, and the
tests hold the two against each other. This package imports `torch` and
never `jax` or `karpenter_tpu`; the pure-Python host modules (api,
scheduling, cloudprovider, encode, oracle) are kept as copies.

Layout:
  api/, utils/, scheduling/, cloudprovider/, testing/   host copies
  ops/vocab.py, ops/encode.py                           host encoding copies
  ops/kernels.py                                        requirement algebra
  device.py                                             device choice, bit words
  solver/tpu_kernel.py                                  the per-pod step (K2)
  solver/tpu.py                                         TorchScheduler (K1)
  csrc/, _build.py                                      CUDA sources, nvcc build
  wire.py, convert.py                                   request decode, reference
                                                        tensors -> port tensors
"""

__version__ = "0.1.0"
