// Error text for the codes the kernel entry points return.
#include "common.cuh"

GFS_EXPORT const char* gfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
