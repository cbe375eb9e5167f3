// C entry for turning a cudaError_t returned by a launcher into text.
#include <cuda_runtime.h>

extern "C" const char* catseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
