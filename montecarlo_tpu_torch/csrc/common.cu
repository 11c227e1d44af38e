// Entries shared by every kernel's Python wrapper (ops/_build.py).

#include <cuda_runtime.h>

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
