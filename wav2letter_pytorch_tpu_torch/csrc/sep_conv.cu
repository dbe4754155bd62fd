// K6 and K7: the fused separable-conv unit of Jasper/QuartzNet,
//     y = ((x * m1) ~dw~ wdw) * m2 @ wpw,
// forward and backward.
//
// Replaces the Pallas TPU kernels of wav2letter_pytorch_tpu/ops/
// sep_conv_pallas.py: K6 is _sep_fwd -> _sep_fwd_kernel, K7 is
// _sep_op_bwd -> _sep_bwd_kernel. x [B, T, Cin], wdw [K, Cin] (depthwise,
// dilation d, symmetric zero padding p, stride 1), wpw [Cin, Cout]
// (pointwise), y [B, T_out, Cout] f32, T_out = T + 2p - d(K-1). Masks, as
// _masks makes them: m1[b, t] = t < len1[b] on the input, m2[b, t] =
// t < len2[b] on the depthwise output, with len1 = int(lens) and len2 =
// int(lens + 2p - d(K-1)) computed by the wrapper (ops/sep_conv.py); null
// lengths mean no mask.
//
// What bounds them on an H100: operations. The pointwise product is
// 2*Cin*Cout FLOP per output frame against (Cin + Cout) * 4 bytes moved,
// ~128 FLOP/byte at Cin = Cout = 256, far over the ~20 FLOP/byte FP32
// balance point; the K depthwise taps add 2*K*Cin. At QuartzNet's B=32,
// T=404 the 76 units of a forward are ~0.4 TFLOP, ~6 ms at the 67 TFLOP/s
// FP32 peak.
//
// Design, K6. The fusion is the point: the depthwise intermediate never
// reaches device memory. A block owns (32 output frames, 256 output
// channels, batch row) and walks Cin in chunks of 32. For each chunk it
// stages x's span (the tile plus its d(K-1) halo, masked by m1 and zero
// outside [0, T)) and the chunk's depthwise weights in shared memory, runs
// the K-tap FMA chain (lane = output frame) into a [32 channels][32 frames]
// shared tile masked by m2, stages the [32, 256] slice of wpw, and
// multiplies the two with a register-blocked FP32 product written here:
// each thread keeps a 4 x 8 block of the [32, 256] output in registers
// across all chunks, reading one float4 of the depthwise tile (a
// broadcast) and two of wpw per input channel. Cout > 256 re-runs the
// depthwise per 256-channel tile (x2 at 512); wgmma and TMA are later work.
//
// Design, K7: five launches from this source on one stream.
//  (i)   gdw = (g @ wpw^T) * m2 [B, T_out, Cin]: a tiled FP32 product
//        (64 x 64 block tile, 4 x 4 per thread) written here.
//  (ii)  one block per (32 channels, batch row) walks the row's time tiles
//        and, from shared copies of x*m1 and gdw with their halos, writes
//        dx = m1 * (the flipped-kernel conv of gdw at padding d(K-1) - p),
//        the recomputed depthwise output dwres = m2 * ((x*m1) ~dw~ wdw) (as
//        the TPU kernel recomputes it, instead of saving it in the
//        forward), and its partial dwdw[k, c] = sum_t x_pad[t + kd] gdw[t].
//  (iii) dwpw = dwres^T @ g with the B*T_out reduction split in a fixed
//        number of chunks, one partial per chunk (the same product code).
//  (iv), (v) the partials of dwdw and dwpw summed in index order
//        (partials.cuh). The TPU accumulated the weight gradients across
//        its sequential grid; here no float atomics are used, so two runs
//        give the same bits.

#include <cuda_runtime.h>

#include "common.cuh"
#include "partials.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CC = 32;       // input channels per chunk / tile, one per lane
constexpr int XS = CC + 1;   // padded shared row
// K6 block tile
constexpr int F_TT = 32;     // output frames (= lanes in the depthwise step)
constexpr int F_OT = 256;    // output channels
// K7 (ii) time tile
constexpr int B_TT = 32;
// Product tile of K7 (i) and (iii)
constexpr int G_BM = 64;
constexpr int G_BN = 64;
constexpr int G_BK = 16;
constexpr int G_PAD = 4;
// Chunks of the B*T_out reduction of dwpw (one partial each)
constexpr int PW_TARGET_BLOCKS = 512;

__host__ __device__ inline int fwd_rows(int K, int d) {
  return F_TT + d * (K - 1);
}

__host__ __device__ inline int bwd_rows(int K, int d) {
  return B_TT + d * (K - 1);
}

__global__ void __launch_bounds__(THREADS)
sep_fwd_kernel(const float* __restrict__ x, const int* __restrict__ len1,
               const int* __restrict__ len2, const float* __restrict__ wdw,
               const float* __restrict__ wpw, float* __restrict__ y, int T,
               int Cin, int Cout, int K, int d, int p, int T_out) {
  extern __shared__ __align__(16) float smem[];
  const int rows = fwd_rows(K, d);
  float* wpw_s = smem;                    // [CC][F_OT]
  float* dwres_s = wpw_s + CC * F_OT;     // [CC][F_TT]
  float* x_s = dwres_s + CC * F_TT;       // [rows][XS]
  float* wdw_s = x_s + rows * XS;         // [K][CC]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * F_TT;
  const int o0 = blockIdx.y * F_OT;
  const int b = blockIdx.z;
  const int l1 = len1 ? min(len1[b], T) : T;
  const int l2 = len2 ? min(len2[b], T_out) : T_out;
  const float* xb = x + (size_t)b * T * Cin;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int c = c0 + lane;
    const bool c_ok = c < Cin;
    __syncthreads();  // the previous chunk's readers are done
    for (int r = warp; r < rows; r += WARPS) {
      const int t = t0 - p + r;
      x_s[r * XS + lane] =
          (c_ok && t >= 0 && t < l1) ? xb[(size_t)t * Cin + c] : 0.f;
    }
    for (int k = warp; k < K; k += WARPS) {
      wdw_s[k * CC + lane] = c_ok ? wdw[(size_t)k * Cin + c] : 0.f;
    }
    for (int i = tid; i < CC * F_OT; i += THREADS) {
      const int cc = i / F_OT;
      const int o = i % F_OT;
      wpw_s[i] = (c0 + cc < Cin && o0 + o < Cout)
                     ? wpw[(size_t)(c0 + cc) * Cout + o0 + o]
                     : 0.f;
    }
    __syncthreads();
    // Depthwise: lane = output frame, each warp 4 of the 32 channels.
    {
      const bool t_ok = t0 + lane < l2;
      const float* xr = x_s + lane * XS;
      for (int cc = warp; cc < CC; cc += WARPS) {
        float a = 0.f;
        if (t_ok) {
          for (int k = 0; k < K; ++k) {
            a = fmaf(xr[k * d * XS + cc], wdw_s[k * CC + cc], a);
          }
        }
        dwres_s[cc * F_TT + lane] = a;
      }
    }
    __syncthreads();
    // Pointwise: rows warp*4 + i, columns lane*4 + j and 128 + lane*4 + j.
#pragma unroll 4
    for (int cc = 0; cc < CC; ++cc) {
      const float4 a =
          *reinterpret_cast<const float4*>(dwres_s + cc * F_TT + warp * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(wpw_s + cc * F_OT + lane * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          wpw_s + cc * F_OT + 128 + lane * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + warp * 4 + i;
    if (t >= T_out) continue;
    float* yr = y + ((size_t)b * T_out + t) * Cout + o0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = (j < 4 ? 0 : 128 - 4) + lane * 4 + j;
      if (o0 + o < Cout) yr[o] = acc[i][j];
    }
  }
}

// C[z] = A @ B over the z-th chunk of the reduction (K) dimension, with
// A(m, k) = A_KCONTIG ? A[m*lda + k] : A[k*lda + m] and B(k, n) = B_KCONTIG
// ? B[n*ldb + k] : B[k*ldb + n]; C[z*split_stride + m*ldc + n]. With
// `row_len`, row m is multiplied by (m % rows_per_b < row_len[m /
// rows_per_b]), the m2 mask of K7 (i).
template <bool A_KCONTIG, bool B_KCONTIG>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ A, long long lda,
            const float* __restrict__ Bm, long long ldb, float* __restrict__ C,
            long long ldc, long long split_stride, int M, int N, int Kd,
            int k_per_split, const int* __restrict__ row_len,
            int rows_per_b) {
  __shared__ __align__(16) float As[G_BK][G_BM + G_PAD];
  __shared__ __align__(16) float Bs[G_BK][G_BN + G_PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * G_BM;
  const int n0 = blockIdx.x * G_BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(Kd, k_begin + k_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kb = k_begin; kb < k_end; kb += G_BK) {
#pragma unroll
    for (int i = 0; i < (G_BK * G_BM) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = A_KCONTIG ? idx % G_BK : idx / G_BM;
      const int mm = A_KCONTIG ? idx / G_BK : idx % G_BM;
      const int m = m0 + mm;
      const int k = kb + kk;
      float v = 0.f;
      if (m < M && k < k_end) {
        v = A_KCONTIG ? A[(size_t)m * lda + k] : A[(size_t)k * lda + m];
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int i = 0; i < (G_BK * G_BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = B_KCONTIG ? idx % G_BK : idx / G_BN;
      const int nn = B_KCONTIG ? idx / G_BK : idx % G_BN;
      const int n = n0 + nn;
      const int k = kb + kk;
      float v = 0.f;
      if (n < N && k < k_end) {
        v = B_KCONTIG ? Bm[(size_t)n * ldb + k] : Bm[(size_t)k * ldb + n];
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < G_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* Cz = C + (size_t)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float scale = 1.f;
    if (row_len) scale = (m % rows_per_b) < row_len[m / rows_per_b] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) Cz[(size_t)m * ldc + n] = acc[i][j] * scale;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sep_bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ gdw,
                  const int* __restrict__ len1, const int* __restrict__ len2,
                  const float* __restrict__ wdw, float* __restrict__ dx,
                  float* __restrict__ dwres, float* __restrict__ part, int T,
                  int Cin, int K, int d, int p, int T_out) {
  extern __shared__ __align__(16) float smem[];
  const int rows = bwd_rows(K, d);
  float* x_s = smem;                 // [rows][XS]: x*m1 from t0 - p
  float* g_s = x_s + rows * XS;      // [rows][XS]: gdw from t0 - pt
  float* wdw_s = g_s + rows * XS;    // [K][CC]
  float* acc_s = wdw_s + K * CC;     // [K][CC]: this row's dwdw
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * CC + lane;
  const int b = blockIdx.y;
  const bool c_ok = c < Cin;
  const int pt = d * (K - 1) - p;
  const int l1 = len1 ? min(len1[b], T) : T;
  const int l2 = len2 ? min(len2[b], T_out) : T_out;
  const int t_all = max(T, T_out);
  const float* xb = x + (size_t)b * T * Cin;
  const float* gb = gdw + (size_t)b * T_out * Cin;

  for (int k = warp; k < K; k += WARPS) {
    wdw_s[k * CC + lane] = c_ok ? wdw[(size_t)k * Cin + c] : 0.f;
    acc_s[k * CC + lane] = 0.f;
  }
  for (int t0 = 0; t0 < t_all; t0 += B_TT) {
    __syncthreads();  // the previous tile's readers are done
    for (int r = warp; r < rows; r += WARPS) {
      const int tx_ = t0 - p + r;
      x_s[r * XS + lane] =
          (c_ok && tx_ >= 0 && tx_ < l1) ? xb[(size_t)tx_ * Cin + c] : 0.f;
      const int tg = t0 - pt + r;
      g_s[r * XS + lane] =
          (c_ok && tg >= 0 && tg < T_out) ? gb[(size_t)tg * Cin + c] : 0.f;
    }
    __syncthreads();
    if (c_ok) {
      for (int tt = warp; tt < B_TT; tt += WARPS) {
        const int t = t0 + tt;
        if (t < T) {
          float a = 0.f;
          if (t < l1) {
            for (int k = 0; k < K; ++k) {
              a = fmaf(g_s[(tt + k * d) * XS + lane],
                       wdw_s[(K - 1 - k) * CC + lane], a);
            }
          }
          dx[((size_t)b * T + t) * Cin + c] = a;
        }
        if (t < T_out) {
          float a = 0.f;
          if (t < l2) {
            for (int k = 0; k < K; ++k) {
              a = fmaf(x_s[(tt + k * d) * XS + lane], wdw_s[k * CC + lane],
                       a);
            }
          }
          dwres[((size_t)b * T_out + t) * Cin + c] = a;
        }
      }
      const int n_t = min(B_TT, T_out - t0);
      for (int k = warp; k < K; k += WARPS) {
        float a = 0.f;
        for (int tt = 0; tt < n_t; ++tt) {
          a = fmaf(x_s[(tt + k * d) * XS + lane], g_s[(tt + pt) * XS + lane],
                   a);
        }
        acc_s[k * CC + lane] += a;  // this thread's own entry
      }
    }
  }
  if (!c_ok) return;
  for (int k = warp; k < K; k += WARPS) {
    part[((size_t)b * K + k) * Cin + c] = acc_s[k * CC + lane];
  }
}

inline size_t fwd_smem(int K, int d) {
  return ((size_t)CC * F_OT + (size_t)CC * F_TT + (size_t)fwd_rows(K, d) * XS +
          (size_t)K * CC) * sizeof(float);
}

inline size_t bwd_smem(int K, int d) {
  return (2 * (size_t)bwd_rows(K, d) * XS + 2 * (size_t)K * CC) *
         sizeof(float);
}

inline int pw_splits(long long m_rows, int Cin, int Cout) {
  const long long tiles = (long long)((Cin + G_BM - 1) / G_BM) *
                          ((Cout + G_BN - 1) / G_BN);
  long long n = (PW_TARGET_BLOCKS + tiles - 1) / tiles;
  const long long max_n = (m_rows + G_BK - 1) / G_BK;  // >= 16 rows each
  if (n > max_n) n = max_n;
  return (int)(n < 1 ? 1 : n);
}

inline int pw_rows_per_split(long long m_rows, int splits) {
  const long long per = (m_rows + splits - 1) / splits;
  return (int)((per + G_BK - 1) / G_BK * G_BK);
}

}  // namespace

extern "C" long long sep_fwd_smem_bytes(int K, int d) {
  return (long long)fwd_smem(K, d);
}

extern "C" long long sep_bwd_smem_bytes(int K, int d) {
  return (long long)bwd_smem(K, d);
}

// Number of partials of dwpw for B*T_out = m_rows (the wrapper sizes the
// scratch buffer with it).
extern "C" int sep_bwd_pw_splits(long long m_rows, int Cin, int Cout) {
  return pw_splits(m_rows, Cin, Cout);
}

// K6 on `stream`: y [B, T_out, Cout]. len1/len2 [B] int32 or null.
extern "C" int sep_fwd_launch(const float* x, const int* len1,
                              const int* len2, const float* wdw,
                              const float* wpw, float* y, int B, int T,
                              int Cin, int Cout, int K, int d, int p,
                              int T_out, void* stream) {
  const size_t smem = fwd_smem(K, d);
  int err = set_smem_limit(sep_fwd_kernel, smem);
  if (err) return err;
  const dim3 grid((T_out + F_TT - 1) / F_TT, (Cout + F_OT - 1) / F_OT, B);
  sep_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, len1, len2, wdw, wpw, y, T, Cin, Cout, K, d, p, T_out);
  return static_cast<int>(cudaGetLastError());
}

// K7 on `stream`: dx [B, T, Cin], dwdw [K, Cin], dwpw [Cin, Cout] from g
// [B, T_out, Cout]. Scratch: gdw and dwres [B, T_out, Cin], part_dw
// [B, K, Cin], part_pw [sep_bwd_pw_splits(...), Cin, Cout]. Five launches.
extern "C" int sep_bwd_launch(const float* x, const int* len1,
                              const int* len2, const float* wdw,
                              const float* wpw, const float* g, float* dx,
                              float* dwdw, float* dwpw, float* gdw,
                              float* dwres, float* part_dw, float* part_pw,
                              int B, int T, int Cin, int Cout, int K, int d,
                              int p, int T_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long m_rows = (long long)B * T_out;
  // (i) gdw = (g @ wpw^T) * m2: A(m, o) = g[m*Cout + o], B(o, c) =
  // wpw[c*Cout + o].
  {
    const dim3 grid((Cin + G_BN - 1) / G_BN,
                    (unsigned)((m_rows + G_BM - 1) / G_BM), 1);
    gemm_kernel<true, true><<<grid, THREADS, 0, st>>>(
        g, Cout, wpw, Cout, gdw, Cin, 0, (int)m_rows, Cin, Cout, Cout, len2,
        T_out);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // (ii) dx, dwres and the per-row partials of dwdw.
  {
    const size_t smem = bwd_smem(K, d);
    int err = set_smem_limit(sep_bwd_dw_kernel, smem);
    if (err) return err;
    const dim3 grid((Cin + CC - 1) / CC, B);
    sep_bwd_dw_kernel<<<grid, THREADS, smem, st>>>(
        x, gdw, len1, len2, wdw, dx, dwres, part_dw, T, Cin, K, d, p, T_out);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // (iii) dwpw partials: A(c, m) = dwres[m*Cin + c], B(m, o) = g[m*Cout + o].
  const int splits = pw_splits(m_rows, Cin, Cout);
  {
    const int per = pw_rows_per_split(m_rows, splits);
    const dim3 grid((Cout + G_BN - 1) / G_BN, (Cin + G_BM - 1) / G_BM,
                    splits);
    gemm_kernel<false, false><<<grid, THREADS, 0, st>>>(
        dwres, Cin, g, Cout, part_pw, Cout, (long long)Cin * Cout, Cin, Cout,
        (int)m_rows, per, nullptr, 1);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // (iv), (v) fixed-order sums of the partials.
  int err = launch_sum_partials(part_dw, B, (long long)K * Cin, dwdw, st);
  if (err) return err;
  return launch_sum_partials(part_pw, splits, (long long)Cin * Cout, dwpw,
                             st);
}
