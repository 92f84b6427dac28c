// Error text for the codes the kernel entry points return.
#include "kmd_common.cuh"

KMD_API const char* kmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
