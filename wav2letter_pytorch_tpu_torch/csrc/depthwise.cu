// K4 and K5: depthwise 1-D convolution, forward and weight gradient.
//
// Replaces the Pallas TPU kernels of wav2letter_pytorch_tpu/ops/
// depthwise_pallas.py: K4 is _dw_pallas -> _dw_fma_kernel,
//     y[b, t, c] = sum_k w[k, c] * x_pad[b, t*s + k*d, c],
// x [B, T, C] f32, w [K, C] f32, stride s, dilation d, symmetric zero
// padding p, y [B, T_out, C], T_out = (T + 2p - d(K-1) - 1) / s + 1; K5 is
// _dw_pallas_wgrad -> _dw_wgrad_kernel,
//     dw[k, c] = sum_{b, t} x_pad[b, t*s + k*d, c] * g[b, t, c].
// The input gradient is K4 again (stride 1, flipped w, on the zero-stuffed
// cotangent), as in _dw_op_bwd; the wrapper (ops/depthwise.py) arranges it.
//
// What bounds them on an H100: bytes. K taps of one FMA per element read
// is 2K operations per 8 bytes moved (x read, y written): at K = 33 that is
// ~8 FLOP/byte, under the card's ~20 FLOP/byte FP32 balance point (67
// TFLOP/s over 3.35 TB/s). The QuartzNet layer (C1: B=32, T=808, C=64,
// stride 2) moves ~10 MB, a few microseconds; launch cost and the halo
// re-read are of the same order.
//
// Design. K4: one block per (time tile of 64 outputs, 32 channels, batch
// row). The block stages its input span, the tile plus its halo of d(K-1)
// frames (zero outside [0, T): the padding), and the tile's K weights in
// shared memory. A lane owns one channel, so global loads and stores of
// the [B, T, C] layout are 128-byte rows, and shared rows are padded to 33
// floats. Each thread runs the K-tap FMA chain for 8 output frames; stride
// and dilation are index arithmetic, no phase planes as on the TPU. Any T.
// K5: the TPU carried dw in VMEM across the batch grid dimension. Here a
// block per (32 channels, batch row) walks that row's time tiles and keeps
// its [K, 32] sums in shared memory (each entry owned by one thread, summed
// in time order), writes them as one partial, and a second launch sums the
// B partials in index order (partials.cuh): no float atomics, so two runs
// give the same bits.

#include <cuda_runtime.h>

#include "common.cuh"
#include "partials.cuh"

namespace {

constexpr int CT = 32;       // channels per block, one per lane
constexpr int WARPS = 8;     // 256 threads
constexpr int THREADS = 32 * WARPS;
constexpr int TT = 64;       // output frames per tile
constexpr int XS = CT + 1;   // padded shared row: no bank conflicts

__host__ __device__ inline int span_rows(int K, int s, int d) {
  return (TT - 1) * s + d * (K - 1) + 1;
}

__global__ void __launch_bounds__(THREADS)
dw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int T, int C, int K, int s, int d, int p,
              int T_out) {
  extern __shared__ float smem[];
  const int rows = span_rows(K, s, d);
  float* x_s = smem;              // [rows][XS]
  float* w_s = smem + rows * XS;  // [K][CT]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * TT;
  const int c = blockIdx.y * CT + lane;
  const int b = blockIdx.z;
  const bool c_ok = c < C;
  const float* xb = x + (size_t)b * T * C;
  const int in0 = t0 * s - p;

  for (int r = warp; r < rows; r += WARPS) {
    const int t = in0 + r;
    x_s[r * XS + lane] =
        (c_ok && t >= 0 && t < T) ? xb[(size_t)t * C + c] : 0.f;
  }
  for (int k = warp; k < K; k += WARPS) {
    w_s[k * CT + lane] = c_ok ? w[(size_t)k * C + c] : 0.f;
  }
  __syncthreads();
  if (!c_ok) return;

  float* yb = y + (size_t)b * T_out * C;
  for (int tt = warp; tt < TT && t0 + tt < T_out; tt += WARPS) {
    const float* xr = x_s + tt * s * XS + lane;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      acc = fmaf(xr[k * d * XS], w_s[k * CT + lane], acc);
    }
    yb[(size_t)(t0 + tt) * C + c] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
dw_wgrad_partial_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, float* __restrict__ part,
                        int T, int C, int K, int s, int d, int p, int T_out) {
  extern __shared__ float smem[];
  const int rows = span_rows(K, s, d);
  float* x_s = smem;                // [rows][XS]
  float* g_s = x_s + rows * XS;     // [TT][XS]
  float* acc_s = g_s + TT * XS;     // [K][CT]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * CT + lane;
  const int b = blockIdx.y;
  const bool c_ok = c < C;
  const float* xb = x + (size_t)b * T * C;
  const float* gb = g + (size_t)b * T_out * C;

  for (int k = warp; k < K; k += WARPS) acc_s[k * CT + lane] = 0.f;
  for (int t0 = 0; t0 < T_out; t0 += TT) {
    __syncthreads();  // the previous tile's readers are done
    const int in0 = t0 * s - p;
    for (int r = warp; r < rows; r += WARPS) {
      const int t = in0 + r;
      x_s[r * XS + lane] =
          (c_ok && t >= 0 && t < T) ? xb[(size_t)t * C + c] : 0.f;
    }
    for (int tt = warp; tt < TT; tt += WARPS) {
      const int t = t0 + tt;
      g_s[tt * XS + lane] = (c_ok && t < T_out) ? gb[(size_t)t * C + c] : 0.f;
    }
    __syncthreads();
    const int n_t = min(TT, T_out - t0);
    for (int k = warp; k < K; k += WARPS) {
      const float* xr = x_s + k * d * XS + lane;
      float a = 0.f;
      for (int tt = 0; tt < n_t; ++tt) {
        a = fmaf(xr[tt * s * XS], g_s[tt * XS + lane], a);
      }
      acc_s[k * CT + lane] += a;  // this thread's own entry
    }
  }
  if (!c_ok) return;
  for (int k = warp; k < K; k += WARPS) {
    part[((size_t)b * K + k) * C + c] = acc_s[k * CT + lane];
  }
}

inline size_t fwd_smem(int K, int s, int d) {
  return ((size_t)span_rows(K, s, d) * XS + (size_t)K * CT) * sizeof(float);
}

inline size_t wgrad_smem(int K, int s, int d) {
  return ((size_t)span_rows(K, s, d) * XS + (size_t)TT * XS +
          (size_t)K * CT) * sizeof(float);
}

}  // namespace

extern "C" long long dw_fwd_smem_bytes(int K, int s, int d) {
  return (long long)fwd_smem(K, s, d);
}

extern "C" long long dw_wgrad_smem_bytes(int K, int s, int d) {
  return (long long)wgrad_smem(K, s, d);
}

// K4 on `stream`: y [B, T_out, C] from x [B, T, C] and w [K, C]. Returns a
// cudaError_t (0 on success).
extern "C" int dw_fwd_launch(const float* x, const float* w, float* y, int B,
                             int T, int C, int K, int s, int d, int p,
                             int T_out, void* stream) {
  const size_t smem = fwd_smem(K, s, d);
  static SmemLimit limit;
  int err = limit.raise_to(dw_fwd_kernel, smem);
  if (err) return err;
  const dim3 grid((T_out + TT - 1) / TT, (C + CT - 1) / CT, B);
  dw_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, y, T, C, K, s, d, p, T_out);
  return static_cast<int>(cudaGetLastError());
}

// K5 on `stream`: dw [K, C] from x [B, T, C] and g [B, T_out, C], through
// `part` [B, K, C] (scratch): two launches.
extern "C" int dw_wgrad_launch(const float* x, const float* g, float* part,
                               float* dw, int B, int T, int C, int K, int s,
                               int d, int p, int T_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = wgrad_smem(K, s, d);
  static SmemLimit limit;
  int err = limit.raise_to(dw_wgrad_partial_kernel, smem);
  if (err) return err;
  const dim3 grid((C + CT - 1) / CT, B);
  dw_wgrad_partial_kernel<<<grid, THREADS, smem, st>>>(x, g, part, T, C, K, s,
                                                       d, p, T_out);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_sum_partials(part, B, (long long)K * C, dw, st);
}
