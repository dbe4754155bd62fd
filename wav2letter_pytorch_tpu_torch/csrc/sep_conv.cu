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
// reaches device memory. A block owns (64 output frames, TN output
// channels, batch row), TN = 256 when Cout <= 256 and 512 otherwise, so at
// QuartzNet's widths one block covers all of Cout and runs each depthwise
// tap once per (frame tile, input channel); Cout > 512 takes more blocks,
// each re-running the depthwise for its slice. TN / 2 threads each keep a
// 16 x 8 block of the output in registers across all of Cin (~245
// registers, no spills: 8 warps an SM at TN = 512, 2 blocks of 4 warps at
// TN = 256; an 8 x 8 block at 128 registers spilled). 64-frame tiles cut
// T_out = 404 into 7 (10 % ragged waste) and give 7 x 32 = 224 blocks:
// one wave at TN = 256, 1.7 at TN = 512.
// The block walks Cin in chunks of 16 through a ring of 3 shared-memory
// stages fed by 16-byte cp.async (4-byte copies when Cin or Cout is not a
// multiple of 4): chunks c+1 and c+2 (x's span, i.e. the tile plus its
// d(K-1) halo, masked by m1 and zero outside [0, T); the depthwise
// weights; the [16, TN] slice of wpw) arrive while chunk c computes:
//  - depthwise: each thread computes FPT = 4 (TN = 512) or 8 (TN = 256)
//    consecutive frames of one channel with independent accumulators; at
//    d = 1 a sliding register window over x, so one shared load feeds FPT
//    taps; the result goes, masked by m2, to a [16][64] shared tile;
//  - product: per input channel a warp (all 64 frames x 64 channels)
//    reads 4 float4s of the tile and 2 of wpw, each 4 or 8 distinct
//    addresses (one shared wavefront), for 128 FMAs a thread.
// FP32 FMA only; each y element is written once, by one thread: no
// atomics. Tensor cores (TF32, 3xTF32) are outside the FP32 policy.
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

#include <cstdint>

#include "common.cuh"
#include "partials.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CC = 32;       // input channels per chunk / tile, one per lane
constexpr int XS = CC + 1;   // padded shared row
// K7 (ii) time tile
constexpr int B_TT = 32;
// Product tile of K7 (i) and (iii)
constexpr int G_BM = 64;
constexpr int G_BN = 64;
constexpr int G_BK = 16;
constexpr int G_PAD = 4;
// Chunks of the B*T_out reduction of dwpw (one partial each)
constexpr int PW_TARGET_BLOCKS = 512;

__host__ __device__ inline int bwd_rows(int K, int d) {
  return B_TT + d * (K - 1);
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

// ---- K6 ------------------------------------------------------------------
// Tile: FM output frames x TN output channels (TN = 256 for Cout <= 256,
// else 512), one batch row, TN / 2 threads of 16 x 8 outputs each; Cin in
// chunks of FC through a ring of F_STAGES shared-memory stages fed by
// cp.async.
constexpr int FM = 64;        // output frames per block
constexpr int FC = 16;        // input channels per chunk
constexpr int F_STAGES = 3;   // cp.async ring depth
constexpr int FMP = FM + 4;   // padded row of a depthwise tile [FC][FMP]
constexpr int FXS = FC + 4;   // padded row of the x span [rows][FXS]

template <int TN>
struct FwdShape {
  static constexpr int THREADS = TN / 2;         // 16 x 8 outputs a thread
  static constexpr int FPT = FC * FM / THREADS;  // depthwise frames a thread
};

__host__ __device__ inline int fwd_rows(int K, int d) {
  return FM + d * (K - 1);
}

template <int TN>
__host__ __device__ inline size_t fwd_stage_floats(int K, int d) {
  return (size_t)fwd_rows(K, d) * FXS + (size_t)K * FC + (size_t)FC * TN;
}

template <int TN>
inline size_t fwd_smem(int K, int d) {
  return (F_STAGES * fwd_stage_floats<TN>(K, d) + (size_t)FC * FMP) *
         sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage chunk c0 of x's span (rows t0 - p ..., masked by m1, zero outside
// [0, T)), of wdw and of wpw's [FC, TN] slice; zero-filled past Cin and
// Cout. STRIDE 4: 16-byte copies (Cin and Cout multiples of 4, aligned
// bases); STRIDE 1: 4-byte copies.
template <int TN, int STRIDE>
__device__ __forceinline__ void fwd_load_stage(
    float* st, const float* __restrict__ xb, const float* __restrict__ wdw,
    const float* __restrict__ wpw, int c0, int t0, int o0, int l1, int Cin,
    int Cout, int K, int p, int rows) {
  constexpr int THREADS = FwdShape<TN>::THREADS;
  float* x_s = st;
  float* wdw_s = x_s + rows * FXS;
  float* wpw_s = wdw_s + K * FC;
  const int tid = threadIdx.x;
  constexpr int PER_ROW = FC / STRIDE;
  for (int i = tid; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int cq = (i % PER_ROW) * STRIDE;
    const int t = t0 - p + r;
    const bool ok = t >= 0 && t < l1 && c0 + cq < Cin;
    const float* src = ok ? xb + (size_t)t * Cin + c0 + cq : xb;
    if constexpr (STRIDE == 4) {
      cp_async16(x_s + r * FXS + cq, src, ok);
    } else {
      cp_async4(x_s + r * FXS + cq, src, ok);
    }
  }
  for (int i = tid; i < K * PER_ROW; i += THREADS) {
    const int k = i / PER_ROW;
    const int cq = (i % PER_ROW) * STRIDE;
    const bool ok = c0 + cq < Cin;
    const float* src = ok ? wdw + (size_t)k * Cin + c0 + cq : wdw;
    if constexpr (STRIDE == 4) {
      cp_async16(wdw_s + k * FC + cq, src, ok);
    } else {
      cp_async4(wdw_s + k * FC + cq, src, ok);
    }
  }
  constexpr int PER_W = TN / STRIDE;
  for (int i = tid; i < FC * PER_W; i += THREADS) {
    const int cc = i / PER_W;
    const int oq = (i % PER_W) * STRIDE;
    const bool ok = c0 + cc < Cin && o0 + oq < Cout;
    const float* src = ok ? wpw + (size_t)(c0 + cc) * Cout + o0 + oq : wpw;
    if constexpr (STRIDE == 4) {
      cp_async16(wpw_s + cc * TN + oq, src, ok);
    } else {
      cp_async4(wpw_s + cc * TN + oq, src, ok);
    }
  }
}

// Depthwise of one staged chunk, masked by m2, into the tile dw [FC][FMP]:
// this thread's channel dc, frames dr..dr+FPT-1, with FPT independent
// accumulators; at d = 1 a sliding window, so one shared load of x feeds
// FPT taps.
template <int TN>
__device__ __forceinline__ void fwd_depthwise(const float* st, float* dw,
                                              int rows, int K, int d, int dc,
                                              int dr, int t0, int l2) {
  constexpr int FPT = FwdShape<TN>::FPT;
  const float* xc = st + dr * FXS + dc;
  const float* wc = st + rows * FXS + dc;
  float a[FPT];
#pragma unroll
  for (int i = 0; i < FPT; ++i) a[i] = 0.f;
  if (d == 1) {
    float win[FPT];
#pragma unroll
    for (int i = 0; i + 1 < FPT; ++i) win[i + 1] = xc[i * FXS];
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i + 1 < FPT; ++i) win[i] = win[i + 1];
      win[FPT - 1] = xc[(k + FPT - 1) * FXS];
      const float w = wc[k * FC];
#pragma unroll
      for (int i = 0; i < FPT; ++i) a[i] = fmaf(win[i], w, a[i]);
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float w = wc[k * FC];
      const float* xk = xc + k * d * FXS;
#pragma unroll
      for (int i = 0; i < FPT; ++i) a[i] = fmaf(xk[i * FXS], w, a[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    if (t0 + dr + i >= l2) a[i] = 0.f;  // m2 (and frames >= T_out)
  }
  float* dst = dw + dc * FMP + dr;
#pragma unroll
  for (int i = 0; i < FPT; i += 4) {
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  }
}

template <int TN>
__global__ void __launch_bounds__(TN / 2, TN == 256 ? 2 : 1)
sep_fwd_kernel(const float* __restrict__ x, const int* __restrict__ len1,
               const int* __restrict__ len2, const float* __restrict__ wdw,
               const float* __restrict__ wpw, float* __restrict__ y, int T,
               int Cin, int Cout, int K, int d, int p, int T_out, int vec) {
  constexpr int FPT = FwdShape<TN>::FPT;
  extern __shared__ __align__(16) float smem[];
  const int rows = fwd_rows(K, d);
  const int stage = (int)fwd_stage_floats<TN>(K, d);
  float* dw_s = smem + F_STAGES * stage;  // [FC][FMP], masked by m2
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * FM;
  const int o0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int l1 = len1 ? min(len1[b], T) : T;
  const int l2 = len2 ? min(len2[b], T_out) : T_out;
  const float* xb = x + (size_t)b * T * Cin;
  const int n_chunks = (Cin + FC - 1) / FC;

  auto load = [&](int chunk) {
    float* st = smem + (chunk % F_STAGES) * stage;
    if (vec) {
      fwd_load_stage<TN, 4>(st, xb, wdw, wpw, chunk * FC, t0, o0, l1, Cin,
                            Cout, K, p, rows);
    } else {
      fwd_load_stage<TN, 1>(st, xb, wdw, wpw, chunk * FC, t0, o0, l1, Cin,
                            Cout, K, p, rows);
    }
  };

  // Product: a warp covers all 64 frames x 64 channels; lane (ty, tx) =
  // (lane / 8, lane % 8) owns frames fm + 16 g + 0..3 (g < 4) and channels
  // cn + 0..3, cn + 32..35. Per input channel a warp reads 4 + 2 float4s,
  // each of 4 or 8 distinct addresses (one shared wavefront), for 128 FMAs.
  const int lane = tid & 31;
  const int fm = (lane >> 3) * 4;
  const int cn = (tid >> 5) * 64 + (lane & 7) * 4;
  // Depthwise: channel dc, frames dr..dr+FPT-1 of the tile.
  const int dc = tid % FC;
  const int dr = (tid / FC) * FPT;

  float acc[16][8];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < n_chunks) load(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // chunk ch landed; everyone is done with ch - 1
    if (ch + F_STAGES - 1 < n_chunks) load(ch + F_STAGES - 1);
    cp_async_commit();
    fwd_depthwise<TN>(smem + (ch % F_STAGES) * stage, dw_s, rows, K, d, dc,
                      dr, t0, l2);
    __syncthreads();
    const float* dwt = dw_s;
    const float* wpw_s = smem + (ch % F_STAGES) * stage + rows * FXS + K * FC;
#pragma unroll 4
    for (int cc = 0; cc < FC; ++cc) {
      float av[16], bv[8];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(dwt + cc * FMP + fm + 16 * g);
        av[4 * g] = a4.x; av[4 * g + 1] = a4.y;
        av[4 * g + 2] = a4.z; av[4 * g + 3] = a4.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(wpw_s + cc * TN + cn + 32 * h);
        bv[4 * h] = b4.x; bv[4 * h + 1] = b4.y;
        bv[4 * h + 2] = b4.z; bv[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int t = t0 + fm + 16 * (i / 4) + i % 4;
    if (t >= T_out) continue;
    float* yr = y + ((size_t)b * T_out + t) * Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + cn + 32 * h;
      if (vec) {
        if (o < Cout) {
          *reinterpret_cast<float4*>(yr + o) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (o + j < Cout) yr[o + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

template <int TN>
int launch_sep_fwd(const float* x, const int* len1, const int* len2,
                   const float* wdw, const float* wpw, float* y, int B,
                   int T, int Cin, int Cout, int K, int d, int p, int T_out,
                   int vec, cudaStream_t stream) {
  static SmemLimit limit;
  const size_t smem = fwd_smem<TN>(K, d);
  int err = limit.raise_to(sep_fwd_kernel<TN>, smem);
  if (err) return err;
  const dim3 grid((T_out + FM - 1) / FM, (Cout + TN - 1) / TN, B);
  sep_fwd_kernel<TN><<<grid, FwdShape<TN>::THREADS, smem, stream>>>(
      x, len1, len2, wdw, wpw, y, T, Cin, Cout, K, d, p, T_out, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of K6 for (K, d, Cout): the tile width follows Cout.
extern "C" long long sep_fwd_smem_bytes(int K, int d, int Cout) {
  return (long long)(Cout <= 256 ? fwd_smem<256>(K, d) : fwd_smem<512>(K, d));
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
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const int vec = Cin % 4 == 0 && Cout % 4 == 0 && aligned(x) &&
                  aligned(wdw) && aligned(wpw) && aligned(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cout <= 256) {
    return launch_sep_fwd<256>(x, len1, len2, wdw, wpw, y, B, T, Cin, Cout,
                               K, d, p, T_out, vec, st);
  }
  return launch_sep_fwd<512>(x, len1, len2, wdw, wpw, y, B, T, Cin, Cout, K,
                             d, p, T_out, vec, st);
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
    static SmemLimit limit;
    int err = limit.raise_to(sep_bwd_dw_kernel, smem);
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
