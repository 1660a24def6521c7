// Shared by every kernel library of the port: the error-string export the
// Python loader (_ext.py) binds.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
