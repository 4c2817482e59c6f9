// Error text for the codes the C entries of this library return.
#include <cuda_runtime.h>

// Codes 1001-1003 are the wgmma loop's (wgmma_conv.cuh: kErrNoEncoder,
// kErrEncode, kErrPlan), 1004 the decoder tail's (decoder_tail.cu).
extern "C" const char* vt_error_string(int code) {
  switch (code) {
    case 1001: return "cuTensorMapEncodeTiled is not available from the CUDA driver";
    case 1002: return "cuTensorMapEncodeTiled refused a tensor map";
    case 1003: return "the wgmma loop refused the plan (BN, stages, shared memory, grid)";
    case 1004: return "the decoder tail refused the plan (patch, C, run, stages, shared memory, grid)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
