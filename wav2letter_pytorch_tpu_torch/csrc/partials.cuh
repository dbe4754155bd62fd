// Fixed-order reduction of per-block partial sums (weight gradients).
//
// On the TPU the grid runs in order, so a weight gradient accumulates in
// VMEM across grid steps. On the card blocks run in parallel and in no
// order; float atomics would make each run's bits differ. So a gradient
// kernel writes one partial per block, part[n][m], and this kernel sums
// them over n in index order: two runs give the same bits. It is launched
// with programmatic dependent launch (common.cuh), so its blocks are
// scheduled while the kernel that writes the partials drains.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

// Loads a thread issues before it adds them: with one load at a time the
// sum of 128 partials (K5 at QuartzNet's C1) waits out 128 L2 latencies.
constexpr int SUM_BATCH = 8;

__global__ void sum_partials_kernel(const float* __restrict__ part, int n,
                                    long long m, float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  wait_prior_grid();
  if (i < m) {
    const float* p = part + i;
    float s = 0.f;
    int j = 0;
    for (; j + SUM_BATCH <= n; j += SUM_BATCH) {
      float v[SUM_BATCH];
#pragma unroll
      for (int u = 0; u < SUM_BATCH; ++u) v[u] = p[(size_t)(j + u) * m];
#pragma unroll
      for (int u = 0; u < SUM_BATCH; ++u) s += v[u];
    }
    for (; j < n; ++j) s += p[(size_t)j * m];
    out[i] = s;
  }
  allow_next_grid();
}

inline int launch_sum_partials(const float* part, int n, long long m,
                               float* out, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  return launch_pdl(sum_partials_kernel, dim3((unsigned)blocks), threads, 0,
                    stream, part, n, m, out);
}
