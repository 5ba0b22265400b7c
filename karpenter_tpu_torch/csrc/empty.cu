// The launch floor: a kernel that does nothing, launched the way every
// kernel of the port is (one ctypes call into a plain C function on
// PyTorch's current stream, then cudaGetLastError). Its device time and the
// host time of its call are the least any launch of the port can cost;
// chip_smoke.py and tools/torch_compare.py set K1, K4 and K5 beside them.
// It replaces no TPU program and no solve runs it.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
