// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_bf16.h>
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

// cp.async copies from device to shared memory: 16 bytes (cache-global) or
// 4 bytes, of any element type; `valid` false zero-fills the destination
// (source size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Elements: float32, or bfloat16 (model.compute_dtype=bf16) read into
// float32 arithmetic and written rounded to nearest even (as XLA's
// astype). load2 reads two neighbouring elements as a float2.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Elements a copy_to_shared moves: 16 bytes' worth with VEC, else one.
template <typename E, bool VEC>
__host__ __device__ constexpr int copy_elems() {
  return VEC ? 16 / (int)sizeof(E) : 1;
}

// Device to shared memory, zero where !valid: 16 bytes by cp.async (VEC),
// else one element, a float by a 4-byte cp.async and a bfloat16 (below
// cp.async's least size) by a plain load and store. A __syncthreads after
// cp_async_wait makes either visible.
template <typename E, bool VEC>
__device__ __forceinline__ void copy_to_shared(E* dst, const E* src,
                                               bool valid) {
  if constexpr (VEC) {
    cp_async16(dst, src, valid);
  } else if constexpr (sizeof(E) == 4) {
    cp_async4(dst, src, valid);
  } else if (valid) {
    *dst = *src;
  } else {
    store(dst, 0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's commit groups are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (sm_90). A kernel launched by launch_pdl
// may have its blocks scheduled while the previous kernel on the stream
// drains; each block calls wait_prior_grid before its first global access
// (it returns once the previous kernel has finished and its writes are
// visible; without the launch attribute it returns at once), and
// allow_next_grid once its own work is issued.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch `kernel` on `st` with programmatic stream serialization. Returns
// a cudaError_t as int.
template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
               cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}
