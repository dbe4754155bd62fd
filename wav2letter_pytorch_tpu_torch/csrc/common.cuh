// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_runtime.h>

// Every library exports this so the Python wrapper can name a failed
// launch's error code.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Set a kernel's dynamic shared memory limit when it needs more than the
// 48 KB default, then launch-check. Returns a cudaError_t as int.
template <typename Kernel>
inline int set_smem_limit(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
