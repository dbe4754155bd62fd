// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_runtime.h>

// Every library exports this so the Python wrapper can name a failed
// launch's error code.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A kernel's dynamic shared memory limit, raised only when a launch needs
// more than the 48 KB default and more than was already set on the current
// device: one launch function keeps one static SmemLimit per kernel, so
// cudaFuncSetAttribute runs once per (kernel, device, larger size), not on
// every launch. raise_to returns a cudaError_t as int.
struct SmemLimit {
  static constexpr int MAX_DEVICES = 64;
  size_t set[MAX_DEVICES] = {};

  template <typename Kernel>
  int raise_to(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool cached = dev >= 0 && dev < MAX_DEVICES;
    if (cached && set[dev] >= bytes) return 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err == cudaSuccess && cached) set[dev] = bytes;
    return static_cast<int>(err);
  }
};
