// Shared by the row-conversion kernels' C interfaces (loaded with ctypes).
//
// Each launcher returns the cudaError_t of its launch as an int (0 = ok);
// the Python wrapper raises with the message this function gives.
//
// Every kernel library exports this function, so it is defined here, inline
// (one definition however many sources include it and are linked together)
// and marked used (emitted in each library although nothing in it calls it).
#pragma once

#include <cuda_runtime.h>

extern "C" inline __attribute__((used)) const char* srj_cuda_error_string(
    int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
