// Launch-error text for the Python wrappers.  Every C entry point of the
// kernel library returns cudaGetLastError() after its launch; the wrapper
// raises with this text when that is not cudaSuccess.
#include <cuda_runtime.h>

extern "C" const char* valve_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
