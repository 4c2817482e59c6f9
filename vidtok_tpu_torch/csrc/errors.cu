// Error text for the codes the C entries of this library return.
#include <cuda_runtime.h>

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
