// Host helpers shared by the kernels' Python wrappers.

#include <cuda_runtime.h>

extern "C" const char* dostpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
