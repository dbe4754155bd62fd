// Fixed-order reduction of per-block partial sums (weight gradients).
//
// On the TPU the grid runs in order, so a weight gradient accumulates in
// VMEM across grid steps. On the card blocks run in parallel and in no
// order; float atomics would make each run's bits differ. So a gradient
// kernel writes one partial per block, part[n][m], and this kernel sums
// them over n in index order: two runs give the same bits.
#pragma once

#include <cuda_runtime.h>

__global__ void sum_partials_kernel(const float* __restrict__ part, int n,
                                    long long m, float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += part[(size_t)j * m + i];
  out[i] = s;
}

inline int launch_sum_partials(const float* part, int n, long long m,
                               float* out, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  sum_partials_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, n, m,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}
