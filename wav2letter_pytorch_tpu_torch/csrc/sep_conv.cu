// K6 and K7: the fused separable-conv unit of Jasper/QuartzNet,
//     y = ((x * m1) ~dw~ wdw) * m2 @ wpw,
// forward and backward.
//
// Replaces the Pallas TPU kernels of wav2letter_pytorch_tpu/ops/
// sep_conv_pallas.py: K6 is _sep_fwd -> _sep_fwd_kernel, K7 is
// _sep_op_bwd -> _sep_bwd_kernel. x [B, T, Cin], wdw [K, Cin] (depthwise,
// dilation d, symmetric zero padding p, stride 1), wpw [Cin, Cout]
// (pointwise), y [B, T_out, Cout] f32, T_out = T + 2p - d(K-1). x is
// float32 or, under model.compute_dtype=bf16, bfloat16 (the TPU kernels'
// contract: bf16 x only, read into float32; the weights, the depthwise
// intermediate, the product and y float32; K7's dx in x's type, rounded to
// nearest even, dwdw and dwpw float32): the x-reading kernels are
// templates on x's element type XT, which stage x as XT. Masks, as
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
//  (ii)  dx = m1 * (the flipped-kernel conv of gdw at padding d(K-1) - p),
//        the recomputed depthwise output dwres = m2 * ((x*m1) ~dw~ wdw) (as
//        the TPU kernel recomputes it, instead of saving it in the
//        forward), and partials of dwdw[k, c] = sum_t x_pad[t + kd] gdw[t].
//        Three depthwise passes, 6*B*T_out*Cin*K FLOP against two reads
//        and two writes of [B, T, Cin]: bound by operations, and by the
//        shared-memory loads that feed them. A block owns 32 channels (one
//        a lane) of one batch row and walks its 64-frame time tiles, or a
//        run of them (the wrapper's plan); a 2-stage ring fed by
//        16-byte cp.async (4-byte when Cin % 4 != 0) brings the next
//        tile's x*m1 and gdw spans, halo included, while this one computes.
//        dx and dwres run K6's depthwise loop (8 frames a thread,
//        independent accumulators, a sliding register window at d = 1, so
//        one shared load feeds 8 taps); dwdw keeps 4-11 taps a thread in
//        registers and slides a window over t, so one load of x feeds all
//        of them. Masked frames are skipped.
//  (iii) dwpw = dwres^T @ g with the B*T_out reduction cut into the plan's
//        runs, one partial each: both operands are k-major, so a 128 x 128
//        block tile (8 x 8 a thread, conflict-free float4 shared loads)
//        takes straight 16-byte cp.async tile copies through a 3-stage
//        ring; one wave of blocks (2 an SM). (i) and (iii) are ~84 % of
//        K7's FLOP, 2*B*T_out*Cin*Cout each, ~128 FLOP a byte at Cin =
//        Cout = 512: bound by operations. (i) stays on its own product:
//        on this ring, with its k-contiguous operands, it was no faster.
//  (iv), (v) the partials of dwdw and dwpw summed in index order
//        (partials.cuh). The TPU accumulated the weight gradients across
//        its sequential grid; here no float atomics are used, so two runs
//        give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "partials.cuh"

namespace {

// ---- K7 (i) -------------------------------------------------------------
constexpr int G_THREADS = 256;
constexpr int G_BM = 64;
constexpr int G_BN = 64;
constexpr int G_BK = 16;
constexpr int G_PAD = 4;

// gdw[m, n] = m2(m) * sum_k g[m*Kd + k] * wpw[n*Kd + k], M = B*T_out rows,
// N = Cin, Kd = Cout: both operands k-contiguous. m2(m) = (m % T_out <
// len2[m / T_out]), or 1 without lengths. 64 x 64 block tiles, 4 x 4 a
// thread, synchronous loads.
__global__ void __launch_bounds__(G_THREADS)
gdw_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ C, int M, int N, int Kd,
                const int* __restrict__ len2, int T_out) {
  __shared__ __align__(16) float As[G_BK][G_BM + G_PAD];
  __shared__ __align__(16) float Bs[G_BK][G_BN + G_PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * G_BM;
  const int n0 = blockIdx.x * G_BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < Kd; kb += G_BK) {
#pragma unroll
    for (int i = 0; i < (G_BK * G_BM) / G_THREADS; ++i) {
      const int idx = tid + i * G_THREADS;
      const int kk = idx % G_BK;
      const int mm = idx / G_BK;
      const int m = m0 + mm;
      const int k = kb + kk;
      As[kk][mm] = m < M && k < Kd ? A[(size_t)m * Kd + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (G_BK * G_BN) / G_THREADS; ++i) {
      const int idx = tid + i * G_THREADS;
      const int kk = idx % G_BK;
      const int nn = idx / G_BK;
      const int n = n0 + nn;
      const int k = kb + kk;
      Bs[kk][nn] = n < N && k < Kd ? Bm[(size_t)n * Kd + k] : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float scale = 1.f;
    if (len2) scale = (m % T_out) < len2[m / T_out] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) C[(size_t)m * N + n] = acc[i][j] * scale;
    }
  }
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

template <int TN>
struct FwdShape {
  static constexpr int THREADS = TN / 2;         // 16 x 8 outputs a thread
  static constexpr int FPT = FC * FM / THREADS;  // depthwise frames a thread
};

// Padded row of the x span [rows][FXS] in elements of XT: FC + 4 floats
// (80 bytes), FC + 8 bfloat16s (48 bytes), rows 16-byte aligned.
template <typename XT>
__host__ __device__ constexpr int fxs() {
  return sizeof(XT) == 4 ? FC + 4 : FC + 8;
}

__host__ __device__ inline int fwd_rows(int K, int d) {
  return FM + d * (K - 1);
}

// A stage: x's span [rows][FXS] as XT, then wdw [K][FC] and wpw's [FC][TN]
// slice as float.
template <typename XT>
__host__ __device__ inline size_t fwd_x_bytes(int K, int d) {
  return (size_t)fwd_rows(K, d) * fxs<XT>() * sizeof(XT);
}

template <int TN, typename XT>
__host__ __device__ inline size_t fwd_stage_bytes(int K, int d) {
  return fwd_x_bytes<XT>(K, d) +
         ((size_t)K * FC + (size_t)FC * TN) * sizeof(float);
}

template <int TN, typename XT>
inline size_t fwd_smem(int K, int d) {
  return F_STAGES * fwd_stage_bytes<TN, XT>(K, d) +
         (size_t)FC * FMP * sizeof(float);
}

// Stage chunk c0 of x's span (rows t0 - p ..., masked by m1, zero outside
// [0, T)), of wdw and of wpw's [FC, TN] slice; zero-filled past Cin and
// Cout. VEC: 16-byte copies (Cin a multiple of 16 bytes of x, Cin and Cout
// multiples of 4, aligned bases); else one element a copy.
template <int TN, typename XT, bool VEC>
__device__ __forceinline__ void fwd_load_stage(
    unsigned char* st, const XT* __restrict__ xb,
    const float* __restrict__ wdw, const float* __restrict__ wpw, int c0,
    int t0, int o0, int l1, int Cin, int Cout, int K, int p, int rows) {
  constexpr int THREADS = FwdShape<TN>::THREADS;
  constexpr int FXS = fxs<XT>();
  XT* x_s = reinterpret_cast<XT*>(st);
  float* wdw_s = reinterpret_cast<float*>(st + (size_t)rows * FXS *
                                                   sizeof(XT));
  float* wpw_s = wdw_s + K * FC;
  const int tid = threadIdx.x;
  constexpr int XSTRIDE = copy_elems<XT, VEC>();
  constexpr int X_PER_ROW = FC / XSTRIDE;
  for (int i = tid; i < rows * X_PER_ROW; i += THREADS) {
    const int r = i / X_PER_ROW;
    const int cq = (i % X_PER_ROW) * XSTRIDE;
    const int t = t0 - p + r;
    const bool ok = t >= 0 && t < l1 && c0 + cq < Cin;
    const XT* src = ok ? xb + (size_t)t * Cin + c0 + cq : xb;
    copy_to_shared<XT, VEC>(x_s + r * FXS + cq, src, ok);
  }
  constexpr int STRIDE = copy_elems<float, VEC>();
  constexpr int PER_ROW = FC / STRIDE;
  for (int i = tid; i < K * PER_ROW; i += THREADS) {
    const int k = i / PER_ROW;
    const int cq = (i % PER_ROW) * STRIDE;
    const bool ok = c0 + cq < Cin;
    const float* src = ok ? wdw + (size_t)k * Cin + c0 + cq : wdw;
    copy_to_shared<float, VEC>(wdw_s + k * FC + cq, src, ok);
  }
  constexpr int PER_W = TN / STRIDE;
  for (int i = tid; i < FC * PER_W; i += THREADS) {
    const int cc = i / PER_W;
    const int oq = (i % PER_W) * STRIDE;
    const bool ok = c0 + cc < Cin && o0 + oq < Cout;
    const float* src = ok ? wpw + (size_t)(c0 + cc) * Cout + o0 + oq : wpw;
    copy_to_shared<float, VEC>(wpw_s + cc * TN + oq, src, ok);
  }
}

// The depthwise loop of K6 and K7 (ii): FPT consecutive frames of one
// channel, a[i] += sum_k xc[(i + k d) * ROW] * wc[k * WSTEP], with FPT
// independent accumulators (x read into float32 from its type XT); at
// d = 1 a sliding register window over x, so one shared load feeds FPT
// taps. A negative WSTEP runs the taps flipped.
template <int FPT, int ROW, int WSTEP, typename XT>
__device__ __forceinline__ void depthwise_frames(const XT* xc,
                                                 const float* wc, int K,
                                                 int d, float (&a)[FPT]) {
  if (d == 1) {
    float win[FPT];
#pragma unroll
    for (int i = 0; i + 1 < FPT; ++i) win[i + 1] = to_f32(xc[i * ROW]);
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i + 1 < FPT; ++i) win[i] = win[i + 1];
      win[FPT - 1] = to_f32(xc[(k + FPT - 1) * ROW]);
      const float w = wc[k * WSTEP];
#pragma unroll
      for (int i = 0; i < FPT; ++i) a[i] = fmaf(win[i], w, a[i]);
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float w = wc[k * WSTEP];
      const XT* xk = xc + k * d * ROW;
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        a[i] = fmaf(to_f32(xk[i * ROW]), w, a[i]);
      }
    }
  }
}

// Depthwise of one staged chunk, masked by m2, into the tile dw [FC][FMP]:
// this thread's channel dc, frames dr..dr+FPT-1.
template <int TN, typename XT>
__device__ __forceinline__ void fwd_depthwise(const unsigned char* st,
                                              float* dw, int rows, int K,
                                              int d, int dc, int dr, int t0,
                                              int l2) {
  constexpr int FPT = FwdShape<TN>::FPT;
  constexpr int FXS = fxs<XT>();
  const XT* x_s = reinterpret_cast<const XT*>(st);
  const float* wdw_s = reinterpret_cast<const float*>(
      st + (size_t)rows * FXS * sizeof(XT));
  float a[FPT];
#pragma unroll
  for (int i = 0; i < FPT; ++i) a[i] = 0.f;
  depthwise_frames<FPT, FXS, FC>(x_s + dr * FXS + dc, wdw_s + dc, K, d, a);
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

template <int TN, typename XT>
__global__ void __launch_bounds__(TN / 2, TN == 256 ? 2 : 1)
sep_fwd_kernel(const XT* __restrict__ x, const int* __restrict__ len1,
               const int* __restrict__ len2, const float* __restrict__ wdw,
               const float* __restrict__ wpw, float* __restrict__ y, int T,
               int Cin, int Cout, int K, int d, int p, int T_out, int vec) {
  constexpr int FPT = FwdShape<TN>::FPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = fwd_rows(K, d);
  const size_t stage = fwd_stage_bytes<TN, XT>(K, d);
  const size_t x_bytes = fwd_x_bytes<XT>(K, d);
  float* dw_s = reinterpret_cast<float*>(  // [FC][FMP], masked by m2
      smem_raw + F_STAGES * stage);
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * FM;
  const int o0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int l1 = len1 ? min(len1[b], T) : T;
  const int l2 = len2 ? min(len2[b], T_out) : T_out;
  const XT* xb = x + (size_t)b * T * Cin;
  const int n_chunks = (Cin + FC - 1) / FC;

  auto load = [&](int chunk) {
    unsigned char* st = smem_raw + (chunk % F_STAGES) * stage;
    if (vec) {
      fwd_load_stage<TN, XT, true>(st, xb, wdw, wpw, chunk * FC, t0, o0, l1,
                                   Cin, Cout, K, p, rows);
    } else {
      fwd_load_stage<TN, XT, false>(st, xb, wdw, wpw, chunk * FC, t0, o0, l1,
                                    Cin, Cout, K, p, rows);
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
    const unsigned char* st = smem_raw + (ch % F_STAGES) * stage;
    fwd_depthwise<TN, XT>(st, dw_s, rows, K, d, dc, dr, t0, l2);
    __syncthreads();
    const float* dwt = dw_s;
    const float* wpw_s =
        reinterpret_cast<const float*>(st + x_bytes) + K * FC;
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

template <int TN, typename XT>
int launch_sep_fwd(const XT* x, const int* len1, const int* len2,
                   const float* wdw, const float* wpw, float* y, int B,
                   int T, int Cin, int Cout, int K, int d, int p, int T_out,
                   int vec, cudaStream_t stream) {
  static SmemLimit limit;
  const size_t smem = fwd_smem<TN, XT>(K, d);
  int err = limit.raise_to(sep_fwd_kernel<TN, XT>, smem);
  if (err) return err;
  const dim3 grid((T_out + FM - 1) / FM, (Cout + TN - 1) / TN, B);
  sep_fwd_kernel<TN, XT><<<grid, FwdShape<TN>::THREADS, smem, stream>>>(
      x, len1, len2, wdw, wpw, y, T, Cin, Cout, K, d, p, T_out, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- K7 (ii) ------------------------------------------------------------
// A block owns DW_CG input channels (one a lane) of one batch row and walks
// `tiles_per_block` consecutive time tiles of DW_TT frames; the next tile's
// spans arrive through a DW_STAGES-deep cp.async ring while this one
// computes. A stage holds x*m1 from t0 - p (x_rows rows) and gdw from
// t0 - pt (g_rows rows), pt = d(K-1) - p, zero outside the sequence.
constexpr int DW_TT = 64;
constexpr int DW_CG = 32;
constexpr int DW_WARPS = 8;
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int DW_FPT = DW_TT / DW_WARPS;  // dx and dwres frames a thread
constexpr int DW_STAGES = 2;

// dwdw taps a thread: the smallest of 4, 6, 8, 11 with which the 8 warps
// cover K in one group of taps each (a warp takes more groups past K = 88).
inline int dw_kpt(int K) {
  if (K <= 4 * DW_WARPS) return 4;
  if (K <= 6 * DW_WARPS) return 6;
  if (K <= 8 * DW_WARPS) return 8;
  return 11;
}

__host__ __device__ inline int dw_groups(int K, int kpt) {
  return (K + kpt - 1) / kpt;
}

__host__ __device__ inline int dw_g_rows(int K, int d) {
  return DW_TT + d * (K - 1);
}

// x's span also covers the last group's taps past K (their sums are
// dropped).
__host__ __device__ inline int dw_x_rows(int K, int d, int kpt) {
  return DW_TT + d * (dw_groups(K, kpt) * kpt - 1);
}

// A stage: x*m1's span [x_rows][DW_CG] as XT, then gdw's [g_rows][DW_CG]
// as float; after the DW_STAGES stages wdw and the dwdw sums, [K][DW_CG]
// floats each.
template <typename XT>
inline size_t dw_stage_bytes(int K, int d) {
  return (size_t)dw_x_rows(K, d, dw_kpt(K)) * DW_CG * sizeof(XT) +
         (size_t)dw_g_rows(K, d) * DW_CG * sizeof(float);
}

template <typename XT>
inline size_t dw_smem(int K, int d) {
  return DW_STAGES * dw_stage_bytes<XT>(K, d) +
         2 * (size_t)K * DW_CG * sizeof(float);
}

// Stage one time tile: x*m1 rows t0 - p + r (zero outside [0, len1)) and
// gdw rows t0 - pt + r (zero outside [0, T_out)), channels c0.. (zero past
// Cin). VEC: 16-byte copies; else one element a copy.
template <typename XT, bool VEC>
__device__ __forceinline__ void dw_load_stage(
    XT* x_s, float* g_s, const XT* __restrict__ xb,
    const float* __restrict__ gb, int c0, int t0, int l1, int T_out,
    int Cin, int p, int pt, int x_rows, int g_rows) {
  constexpr int XSTRIDE = copy_elems<XT, VEC>();
  constexpr int X_PER_ROW = DW_CG / XSTRIDE;
  for (int i = threadIdx.x; i < x_rows * X_PER_ROW; i += DW_THREADS) {
    const int r = i / X_PER_ROW;
    const int cq = (i % X_PER_ROW) * XSTRIDE;
    const int t = t0 - p + r;
    const bool ok = t >= 0 && t < l1 && c0 + cq < Cin;
    const XT* src = ok ? xb + (size_t)t * Cin + c0 + cq : xb;
    copy_to_shared<XT, VEC>(x_s + r * DW_CG + cq, src, ok);
  }
  constexpr int STRIDE = copy_elems<float, VEC>();
  constexpr int PER_ROW = DW_CG / STRIDE;
  for (int i = threadIdx.x; i < g_rows * PER_ROW; i += DW_THREADS) {
    const int r = i / PER_ROW;
    const int cq = (i % PER_ROW) * STRIDE;
    const int t = t0 - pt + r;
    const bool ok = t >= 0 && t < T_out && c0 + cq < Cin;
    const float* src = ok ? gb + (size_t)t * Cin + c0 + cq : gb;
    copy_to_shared<float, VEC>(g_s + r * DW_CG + cq, src, ok);
  }
}

// dwdw of one channel over a tile: acc[j] += sum_{tt < n_t} xk[(tt + j d)
// * DW_CG] * gt[tt * DW_CG], for KPT taps; at d = 1 a register window over
// t, so one shared load of x feeds KPT taps.
template <int KPT, typename XT>
__device__ __forceinline__ void dwdw_taps(const XT* xk, const float* gt,
                                          int n_t, int d, float (&acc)[KPT]) {
  if (d == 1) {
    float win[KPT];
#pragma unroll
    for (int j = 0; j + 1 < KPT; ++j) win[j + 1] = to_f32(xk[j * DW_CG]);
#pragma unroll 8
    for (int tt = 0; tt < n_t; ++tt) {
#pragma unroll
      for (int j = 0; j + 1 < KPT; ++j) win[j] = win[j + 1];
      win[KPT - 1] = to_f32(xk[(tt + KPT - 1) * DW_CG]);
      const float g = gt[tt * DW_CG];
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[j] = fmaf(win[j], g, acc[j]);
    }
  } else {
#pragma unroll 2
    for (int tt = 0; tt < n_t; ++tt) {
      const float g = gt[tt * DW_CG];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        acc[j] = fmaf(to_f32(xk[(tt + j * d) * DW_CG]), g, acc[j]);
      }
    }
  }
}

// dx = m1 * (gdw ~ flipped wdw at padding pt), dwres = m2 * ((x*m1) ~ wdw),
// and this block's partial of dwdw[k, c] = sum_t x_pad[t + kd] gdw[t]
// (part[(b * gridDim.y + blockIdx.y), k, c]). Grid (Cin / DW_CG, time
// groups, B). Thread (lane, warp): channel c0 + lane; dx and dwres of
// frames warp * DW_FPT + 0..DW_FPT-1 of each tile; dwdw of tap groups warp,
// warp + 8, ... of KPT taps, summed over tiles in acc_s, which only the
// owning thread touches (no atomics).
template <int KPT, typename XT, bool VEC>
__global__ void __launch_bounds__(DW_THREADS, 2)
sep_bwd_dw_kernel(const XT* __restrict__ x, const float* __restrict__ gdw,
                  const int* __restrict__ len1, const int* __restrict__ len2,
                  const float* __restrict__ wdw, XT* __restrict__ dx,
                  float* __restrict__ dwres, float* __restrict__ part, int T,
                  int Cin, int K, int d, int p, int T_out,
                  int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int x_rows = dw_x_rows(K, d, KPT);
  const int g_rows = dw_g_rows(K, d);
  const size_t x_bytes = (size_t)x_rows * DW_CG * sizeof(XT);
  const size_t stage = x_bytes + (size_t)g_rows * DW_CG * sizeof(float);
  float* wdw_s = reinterpret_cast<float*>(  // [K][DW_CG]
      smem_raw + DW_STAGES * stage);
  float* acc_s = wdw_s + K * DW_CG;         // [K][DW_CG]: dwdw so far
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * DW_CG;
  const int c = c0 + lane;
  const bool c_ok = c < Cin;
  const int b = blockIdx.z;
  const int pt = d * (K - 1) - p;
  const int l1 = len1 ? min(len1[b], T) : T;
  const int l2 = len2 ? min(len2[b], T_out) : T_out;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int n_tiles = min(tiles_per_block,
                          (max(T, T_out) + DW_TT - 1) / DW_TT - tile0);
  const XT* xb = x + (size_t)b * T * Cin;
  const float* gb = gdw + (size_t)b * T_out * Cin;
  const int groups = dw_groups(K, KPT);

  auto load = [&](int it) {
    unsigned char* st = smem_raw + (it % DW_STAGES) * stage;
    dw_load_stage<XT, VEC>(reinterpret_cast<XT*>(st),
                           reinterpret_cast<float*>(st + x_bytes), xb, gb,
                           c0, (tile0 + it) * DW_TT, l1, T_out, Cin, p, pt,
                           x_rows, g_rows);
  };
  load(0);
  cp_async_commit();
  for (int k = warp; k < K; k += DW_WARPS) {
    wdw_s[k * DW_CG + lane] = c_ok ? wdw[(size_t)k * Cin + c] : 0.f;
    acc_s[k * DW_CG + lane] = 0.f;
  }
  const int dr = warp * DW_FPT;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it landed (and wdw_s, acc_s are set)
    const unsigned char* st = smem_raw + (it % DW_STAGES) * stage;
    const XT* x_s = reinterpret_cast<const XT*>(st);
    const float* g_s = reinterpret_cast<const float*>(st + x_bytes);
    const int t0 = (tile0 + it) * DW_TT;

    float a[DW_FPT], bk[DW_FPT];
#pragma unroll
    for (int i = 0; i < DW_FPT; ++i) a[i] = bk[i] = 0.f;
    if (t0 + dr < l2) {  // dwres
      depthwise_frames<DW_FPT, DW_CG, DW_CG>(x_s + dr * DW_CG + lane,
                                             wdw_s + lane, K, d, a);
    }
    if (t0 + dr < l1) {  // dx: the taps flipped
      depthwise_frames<DW_FPT, DW_CG, -DW_CG>(
          g_s + dr * DW_CG + lane, wdw_s + (K - 1) * DW_CG + lane, K, d, bk);
    }
    if (c_ok) {
#pragma unroll
      for (int i = 0; i < DW_FPT; ++i) {
        const int t = t0 + dr + i;
        if (t < T_out) {
          dwres[((size_t)b * T_out + t) * Cin + c] = t < l2 ? a[i] : 0.f;
        }
        if (t < T) {
          store(dx + ((size_t)b * T + t) * Cin + c, t < l1 ? bk[i] : 0.f);
        }
      }
    }

    const int n_t = min(DW_TT, l2 - t0);  // gdw is zero from l2 on
    for (int grp = warp; grp < groups && n_t > 0; grp += DW_WARPS) {
      float acc[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[j] = 0.f;
      dwdw_taps<KPT>(x_s + grp * KPT * d * DW_CG + lane,
                     g_s + pt * DW_CG + lane, n_t, d, acc);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = grp * KPT + j;
        if (k < K) acc_s[k * DW_CG + lane] += acc[j];
      }
    }
    __syncthreads();  // everyone is done with this stage
  }
  if (!c_ok) return;
  float* pb = part + (size_t)(b * gridDim.y + blockIdx.y) * K * Cin;
  for (int k = warp; k < K; k += DW_WARPS) {
    pb[(size_t)k * Cin + c] = acc_s[k * DW_CG + lane];
  }
}

template <int KPT, typename XT>
int launch_bwd_dw(const XT* x, const float* gdw, const int* len1,
                  const int* len2, const float* wdw, XT* dx, float* dwres,
                  float* part, int B, int T, int Cin, int K, int d, int p,
                  int T_out, int tiles_per_block, int time_groups, int vec,
                  cudaStream_t stream) {
  static SmemLimit limit_vec, limit_one;
  const size_t smem = dw_smem<XT>(K, d);
  const dim3 grid((Cin + DW_CG - 1) / DW_CG, time_groups, B);
  int err;
  if (vec) {
    err = limit_vec.raise_to(sep_bwd_dw_kernel<KPT, XT, true>, smem);
    if (err) return err;
    sep_bwd_dw_kernel<KPT, XT, true><<<grid, DW_THREADS, smem, stream>>>(
        x, gdw, len1, len2, wdw, dx, dwres, part, T, Cin, K, d, p, T_out,
        tiles_per_block);
  } else {
    err = limit_one.raise_to(sep_bwd_dw_kernel<KPT, XT, false>, smem);
    if (err) return err;
    sep_bwd_dw_kernel<KPT, XT, false><<<grid, DW_THREADS, smem, stream>>>(
        x, gdw, len1, len2, wdw, dx, dwres, part, T, Cin, K, d, p, T_out,
        tiles_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- K7 (iii) -----------------------------------------------------------
// C[z] = sum over the rows r of run z of A[r*lda + m] * B[r*ldb + n]: both
// operands k-major (A = dwres, B = g), so a stage is two straight tile
// copies. A block computes PW_BM x PW_BN outputs, a thread 8 x 8 (rows
// ty*4 + 0..3 and 64 + ty*4 + 0..3, columns likewise from tx): per row of
// a stage, two float4 shared loads of A (a warp reads 2 addresses) and two
// of B (16 consecutive float4s) feed 64 FMAs. PW_BK rows a stage through a
// PW_STAGES-deep cp.async ring; rows, M and N past their ends are zero.
constexpr int PW_BM = 128;
constexpr int PW_BN = 128;
constexpr int PW_BK = 16;
constexpr int PW_STAGES = 3;
constexpr int PW_THREADS = 256;
constexpr size_t PW_SMEM =
    (size_t)PW_STAGES * PW_BK * (PW_BM + PW_BN) * sizeof(float);

template <int STRIDE>
__global__ void __launch_bounds__(PW_THREADS, 2)
pw_gemm_kernel(const float* __restrict__ A, int lda,
               const float* __restrict__ Bm, int ldb, float* __restrict__ C,
               int M, int N, long long rows, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * PW_BM;
  const int n0 = blockIdx.x * PW_BN;
  const long long r0 = (long long)blockIdx.z * rows_per_split;
  const long long r_end = min(rows, r0 + rows_per_split);
  const int nk = (int)((r_end - r0 + PW_BK - 1) / PW_BK);

  auto load = [&](int kt) {
    float* As = smem + (kt % PW_STAGES) * PW_BK * (PW_BM + PW_BN);
    float* Bs = As + PW_BK * PW_BM;
    constexpr int PER_A = PW_BM / STRIDE;
    for (int i = tid; i < PW_BK * PER_A; i += PW_THREADS) {
      const int kk = i / PER_A;
      const int mq = (i % PER_A) * STRIDE;
      const long long r = r0 + (long long)kt * PW_BK + kk;
      const bool ok = r < r_end && m0 + mq < M;
      const float* src = ok ? A + r * lda + m0 + mq : A;
      if constexpr (STRIDE == 4) {
        cp_async16(As + kk * PW_BM + mq, src, ok);
      } else {
        cp_async4(As + kk * PW_BM + mq, src, ok);
      }
    }
    constexpr int PER_B = PW_BN / STRIDE;
    for (int i = tid; i < PW_BK * PER_B; i += PW_THREADS) {
      const int kk = i / PER_B;
      const int nq = (i % PER_B) * STRIDE;
      const long long r = r0 + (long long)kt * PW_BK + kk;
      const bool ok = r < r_end && n0 + nq < N;
      const float* src = ok ? Bm + r * ldb + n0 + nq : Bm;
      if constexpr (STRIDE == 4) {
        cp_async16(Bs + kk * PW_BN + nq, src, ok);
      } else {
        cp_async4(Bs + kk * PW_BN + nq, src, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < PW_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<PW_STAGES - 2>();
    __syncthreads();  // stage kt landed; everyone is done with kt - 1
    if (kt + PW_STAGES - 1 < nk) load(kt + PW_STAGES - 1);
    cp_async_commit();
    const float* As = smem + (kt % PW_STAGES) * PW_BK * (PW_BM + PW_BN);
    const float* Bs = As + PW_BK * PW_BM;
#pragma unroll
    for (int kk = 0; kk < PW_BK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            As + kk * PW_BM + 64 * h + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(
            Bs + kk * PW_BN + 64 * h + tx * 4);
        av[4 * h] = a4.x; av[4 * h + 1] = a4.y;
        av[4 * h + 2] = a4.z; av[4 * h + 3] = a4.w;
        bv[4 * h] = b4.x; bv[4 * h + 1] = b4.y;
        bv[4 * h + 2] = b4.z; bv[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  float* Cz = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 64 * (i / 4) + ty * 4 + i % 4;
    if (m >= M) continue;
    float* cr = Cz + (size_t)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + tx * 4;
      if constexpr (STRIDE == 4) {
        if (n < N) {
          *reinterpret_cast<float4*>(cr + n) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < N) cr[n + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

// K6 and K7 on one x element type XT (K7's dx is XT too).
template <typename XT>
int sep_fwd_entry(const XT* x, const int* len1, const int* len2,
                  const float* wdw, const float* wpw, float* y, int B, int T,
                  int Cin, int Cout, int K, int d, int p, int T_out,
                  cudaStream_t st) {
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const int vec = Cin % copy_elems<XT, true>() == 0 && Cout % 4 == 0 &&
                  aligned(x) && aligned(wdw) && aligned(wpw) && aligned(y);
  if (Cout <= 256) {
    return launch_sep_fwd<256>(x, len1, len2, wdw, wpw, y, B, T, Cin, Cout,
                               K, d, p, T_out, vec, st);
  }
  return launch_sep_fwd<512>(x, len1, len2, wdw, wpw, y, B, T, Cin, Cout, K,
                             d, p, T_out, vec, st);
}

template <typename XT>
int sep_bwd_entry(const XT* x, const int* len1, const int* len2,
                  const float* wdw, const float* wpw, const float* g, XT* dx,
                  float* dwdw, float* dwpw, float* gdw, float* dwres,
                  float* part_dw, float* part_pw, int B, int T, int Cin,
                  int Cout, int K, int d, int p, int T_out,
                  int tiles_per_block, int time_groups, int pw_splits,
                  int pw_rows, cudaStream_t st) {
  const long long m_rows = (long long)B * T_out;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  // (i) gdw = (g @ wpw^T) * m2.
  {
    const dim3 grid((Cin + G_BN - 1) / G_BN,
                    (unsigned)((m_rows + G_BM - 1) / G_BM));
    gdw_gemm_kernel<<<grid, G_THREADS, 0, st>>>(g, wpw, gdw, (int)m_rows,
                                                Cin, Cout, len2, T_out);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // (ii) dx, dwres and the per-block partials of dwdw.
  {
    const int vec = Cin % copy_elems<XT, true>() == 0 && aligned(x) &&
                    aligned(gdw);
    auto run = launch_bwd_dw<11, XT>;
    switch (dw_kpt(K)) {
      case 4: run = launch_bwd_dw<4, XT>; break;
      case 6: run = launch_bwd_dw<6, XT>; break;
      case 8: run = launch_bwd_dw<8, XT>; break;
    }
    int err = run(x, gdw, len1, len2, wdw, dx, dwres, part_dw, B, T, Cin, K,
                  d, p, T_out, tiles_per_block, time_groups, vec, st);
    if (err) return err;
  }
  // (iii) dwpw partials: A(c, m) = dwres[m*Cin + c], B(m, o) = g[m*Cout + o].
  {
    const dim3 grid((Cout + PW_BN - 1) / PW_BN, (Cin + PW_BM - 1) / PW_BM,
                    pw_splits);
    const bool vec = Cin % 4 == 0 && Cout % 4 == 0 && aligned(dwres) &&
                     aligned(g) && aligned(part_pw);
    if (vec) {
      pw_gemm_kernel<4><<<grid, PW_THREADS, PW_SMEM, st>>>(
          dwres, Cin, g, Cout, part_pw, Cin, Cout, m_rows, pw_rows);
    } else {
      pw_gemm_kernel<1><<<grid, PW_THREADS, PW_SMEM, st>>>(
          dwres, Cin, g, Cout, part_pw, Cin, Cout, m_rows, pw_rows);
    }
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // (iv), (v) fixed-order sums of the partials.
  int err = launch_sum_partials(part_dw, B * time_groups, (long long)K * Cin,
                                dwdw, st);
  if (err) return err;
  return launch_sum_partials(part_pw, pw_splits, (long long)Cin * Cout, dwpw,
                             st);
}

}  // namespace

// Shared memory of K6 for (K, d, Cout) at x elements of `esize` bytes (4
// float32, 2 bfloat16): the tile width follows Cout.
extern "C" long long sep_fwd_smem_bytes(int K, int d, int Cout, int esize) {
  if (esize == 2) {
    return (long long)(Cout <= 256 ? fwd_smem<256, __nv_bfloat16>(K, d)
                                   : fwd_smem<512, __nv_bfloat16>(K, d));
  }
  return (long long)(Cout <= 256 ? fwd_smem<256, float>(K, d)
                                 : fwd_smem<512, float>(K, d));
}

// Shared memory of K7's depthwise pass for (K, d) at x elements of `esize`
// bytes.
extern "C" long long sep_bwd_smem_bytes(int K, int d, int esize) {
  return (long long)(esize == 2 ? dw_smem<__nv_bfloat16>(K, d)
                                : dw_smem<float>(K, d));
}

// K6 on `stream`: y [B, T_out, Cout]. len1/len2 [B] int32 or null.
// sep_fwd_launch_bf16: the same on bfloat16 x.
extern "C" int sep_fwd_launch(const float* x, const int* len1,
                              const int* len2, const float* wdw,
                              const float* wpw, float* y, int B, int T,
                              int Cin, int Cout, int K, int d, int p,
                              int T_out, void* stream) {
  return sep_fwd_entry(x, len1, len2, wdw, wpw, y, B, T, Cin, Cout, K, d, p,
                       T_out, static_cast<cudaStream_t>(stream));
}

extern "C" int sep_fwd_launch_bf16(const __nv_bfloat16* x, const int* len1,
                                   const int* len2, const float* wdw,
                                   const float* wpw, float* y, int B, int T,
                                   int Cin, int Cout, int K, int d, int p,
                                   int T_out, void* stream) {
  return sep_fwd_entry(x, len1, len2, wdw, wpw, y, B, T, Cin, Cout, K, d, p,
                       T_out, static_cast<cudaStream_t>(stream));
}

// K7 on `stream`: dx [B, T, Cin], dwdw [K, Cin], dwpw [Cin, Cout] from g
// [B, T_out, Cout]. Scratch: gdw and dwres [B, T_out, Cin], part_dw
// [B * time_groups, K, Cin], part_pw [pw_splits, Cin, Cout]; the plan
// (tiles_per_block, time_groups, pw_splits, pw_rows) comes from the
// wrapper (ops/sep_conv.py::bwd_plan). Five launches.
// sep_bwd_launch_bf16: the same on bfloat16 x and dx.
extern "C" int sep_bwd_launch(const float* x, const int* len1,
                              const int* len2, const float* wdw,
                              const float* wpw, const float* g, float* dx,
                              float* dwdw, float* dwpw, float* gdw,
                              float* dwres, float* part_dw, float* part_pw,
                              int B, int T, int Cin, int Cout, int K, int d,
                              int p, int T_out, int tiles_per_block,
                              int time_groups, int pw_splits, int pw_rows,
                              void* stream) {
  return sep_bwd_entry(x, len1, len2, wdw, wpw, g, dx, dwdw, dwpw, gdw,
                       dwres, part_dw, part_pw, B, T, Cin, Cout, K, d, p,
                       T_out, tiles_per_block, time_groups, pw_splits,
                       pw_rows, static_cast<cudaStream_t>(stream));
}

extern "C" int sep_bwd_launch_bf16(
    const __nv_bfloat16* x, const int* len1, const int* len2,
    const float* wdw, const float* wpw, const float* g, __nv_bfloat16* dx,
    float* dwdw, float* dwpw, float* gdw, float* dwres, float* part_dw,
    float* part_pw, int B, int T, int Cin, int Cout, int K, int d, int p,
    int T_out, int tiles_per_block, int time_groups, int pw_splits,
    int pw_rows, void* stream) {
  return sep_bwd_entry(x, len1, len2, wdw, wpw, g, dx, dwdw, dwpw, gdw,
                       dwres, part_dw, part_pw, B, T, Cin, Cout, K, d, p,
                       T_out, tiles_per_block, time_groups, pw_splits,
                       pw_rows, static_cast<cudaStream_t>(stream));
}
