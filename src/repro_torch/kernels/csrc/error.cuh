// The C entry every library of the port exports for `_build.launch`'s
// error messages.
#pragma once

#include <cuda_runtime.h>

// Each shared library is built from exactly one .cu file that includes this
// header, so this C entry is defined once per library.
extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
