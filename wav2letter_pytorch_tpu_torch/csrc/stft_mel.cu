// K1: fused framing -> window -> real FFT -> power -> banded mel ->
// log1p(+2^-24).
//
// Replaces the Pallas TPU kernel wav2letter_pytorch_tpu/ops/stft_pallas.py
// (stft_mel_log_pallas -> _kernel), which multiplies each frame by a dense
// [n_fft, n_bins] DFT basis on the MXU. Input: centre-padded audio [B, P]
// f32; output: log-mel [B, n_frames, n_mels] f32, where frame f covers
// samples [f*hop, f*hop + n_fft) of its row.
//
// What bounds it on an H100: bytes. With an FFT a frame of n_fft = 512
// costs ~15 k operations, so at the main path (B=32, 808 frames, 64 mels)
// the ~0.38 GFLOP take ~6 us at the 67 TFLOP/s FP32 peak, while reading
// the padded audio once (16.6 MB) and writing the log-mel (6.6 MB) take
// ~7 us at 3.35 TB/s. The dense DFT it replaces was 13.6 GFLOP.
//
// Design: one block per (batch row, tile of FT frames), FT * n_fft / 2 =
// 2048 complex points per block (FT = 8 at n_fft 512, 1 at 4096, 32 at
// 64-128). The block copies its contiguous audio span, (FT-1)*hop + n_fft
// samples, into shared memory once; frames are overlapping views of it.
//  1. Window on load, packed as z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1],
//     n < M = n_fft / 2.
//  2. An M-point complex FFT per frame: Stockham autosort passes in shared
//     memory, ping-pong between two buffers, one radix-2 pass first when
//     log2 M is odd, then radix-4 passes (pass with span p: butterfly i of
//     each frame reads x[i + r M/R], r < R, multiplies by W^(r k)_(R p),
//     k = i mod p, and writes y[(i - k) R + k + r p]). Shared memory rather
//     than registers and shuffles because one schedule then serves every
//     n_fft from 64 to 4096, and the FFT is a small part of the time: the
//     kernel is bound by its global bytes. A radix-4 pass halves the
//     passes (and the __syncthreads between them) of radix 2.
//  3. Split step to the n_fft-point real spectrum, k = 0..M:
//     X[k] = (Z[k] + conj Z[M-k]) / 2 - i W_N^k (Z[k] - conj Z[M-k]) / 2,
//     then power |X[k]|^2 into the free buffer.
//  4. Banded mel: each Slaney filter is nonzero on one contiguous run of
//     bins, so mel m sums count[m] weights (packed, from the frontend's
//     band table) times the power: ~2 FMAs per bin per frame instead of
//     n_mels.
//  5. log1p(mel + 2^-24), written [frame, mel] (coalesced).
// Twiddles cos/sin(2 pi k / N), k < N, are computed in float64 on the host
// and stored as float32 (no fast-math sin/cos); the complex FFT reads
// W_M^m as entry 2m. All arithmetic is FP32; no library call.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int POINTS_PER_BLOCK = 2048;  // complex points: FT * n_fft / 2
constexpr int MAX_FT = 32;
constexpr float LOG_ZERO_GUARD = 5.9604644775390625e-08f;  // 2^-24

__host__ __device__ inline int frames_per_block(int n_fft) {
  const int f = 2 * POINTS_PER_BLOCK / n_fft;
  return f < 1 ? 1 : (f > MAX_FT ? MAX_FT : f);
}

__host__ __device__ inline int span_floats(int hop, int n_fft) {
  const int span = (frames_per_block(n_fft) - 1) * hop + n_fft;
  return (span + 3) / 4 * 4;  // keep the float2 buffers 16-byte aligned
}

__host__ __device__ inline size_t smem_bytes(int hop, int n_fft) {
  const size_t pts = (size_t)frames_per_block(n_fft) * (n_fft / 2);
  return span_floats(hop, n_fft) * sizeof(float) + 2 * pts * sizeof(float2);
}

__device__ inline float2 cmul_conj_tw(float2 u, float2 cs) {
  // u * (cos - i sin)
  return make_float2(u.x * cs.x + u.y * cs.y, u.y * cs.x - u.x * cs.y);
}

__global__ void __launch_bounds__(THREADS)
stft_mel_log_kernel(const float* __restrict__ audio, long long P,
                    const float* __restrict__ window,
                    const float2* __restrict__ tw, int n_fft, int log2_m,
                    const int* __restrict__ bands,
                    const float* __restrict__ weights, int n_mels, int hop,
                    int n_frames, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int FT = frames_per_block(n_fft);
  const int M = n_fft >> 1;
  const int pts = FT * M;
  float* s_audio = smem;
  float2* buf0 = reinterpret_cast<float2*>(smem + span_floats(hop, n_fft));
  float2* buf1 = buf0 + pts;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* x = audio + (size_t)b * P;
  const long long start = (long long)f0 * hop;
  const int span = (FT - 1) * hop + n_fft;
  for (int i = tid; i < span; i += THREADS) {
    const long long p = start + i;
    s_audio[i] = p < P ? x[p] : 0.f;
  }
  __syncthreads();

  // 1. Window and pack the real frame as M complex points.
  const float2* win2 = reinterpret_cast<const float2*>(window);
  for (int idx = tid; idx < pts; idx += THREADS) {
    const int fi = idx >> log2_m;
    const int n = idx & (M - 1);
    const float2 w = __ldg(win2 + n);
    const float* s = s_audio + fi * hop + 2 * n;
    buf0[idx] = make_float2(s[0] * w.x, s[1] * w.y);
  }
  __syncthreads();

  // 2. Stockham passes: radix 2 first if log2 M is odd, then radix 4.
  float2* src = buf0;
  float2* dst = buf1;
  int p = 1;
  int log2_p = 0;
  if (log2_m & 1) {
    const int q = M >> 1;
    for (int idx = tid; idx < (pts >> 1); idx += THREADS) {
      const int fi = idx >> (log2_m - 1);
      const int i = idx & (q - 1);
      const float2* s = src + fi * M;
      float2* d = dst + fi * M;
      const float2 u0 = s[i], u1 = s[i + q];
      d[2 * i] = make_float2(u0.x + u1.x, u0.y + u1.y);
      d[2 * i + 1] = make_float2(u0.x - u1.x, u0.y - u1.y);
    }
    __syncthreads();
    float2* t = src; src = dst; dst = t;
    p = 2;
    log2_p = 1;
  }
  for (; p < M; p <<= 2, log2_p += 2) {
    const int q = M >> 2;
    // W^(r k)_(4p) is twiddle entry r k N / (4p),
    // i.e. r k << (log2 N - 2 - log2 p).
    const int tw_shift = log2_m - 1 - log2_p;
    for (int idx = tid; idx < (pts >> 2); idx += THREADS) {
      const int fi = idx >> (log2_m - 2);
      const int i = idx & (q - 1);
      const int k = i & (p - 1);
      const float2* s = src + fi * M;
      float2* d = dst + fi * M;
      const float2 u0 = s[i];
      float2 u1 = s[i + q], u2 = s[i + 2 * q], u3 = s[i + 3 * q];
      if (k) {
        u1 = cmul_conj_tw(u1, __ldg(tw + (k << tw_shift)));
        u2 = cmul_conj_tw(u2, __ldg(tw + ((2 * k) << tw_shift)));
        u3 = cmul_conj_tw(u3, __ldg(tw + ((3 * k) << tw_shift)));
      }
      const float2 a0 = make_float2(u0.x + u2.x, u0.y + u2.y);
      const float2 a1 = make_float2(u0.x - u2.x, u0.y - u2.y);
      const float2 a2 = make_float2(u1.x + u3.x, u1.y + u3.y);
      const float2 a3 = make_float2(u1.x - u3.x, u1.y - u3.y);
      const int j = ((i - k) << 2) + k;
      d[j] = make_float2(a0.x + a2.x, a0.y + a2.y);
      d[j + p] = make_float2(a1.x + a3.y, a1.y - a3.x);       // a1 - i a3
      d[j + 2 * p] = make_float2(a0.x - a2.x, a0.y - a2.y);
      d[j + 3 * p] = make_float2(a1.x - a3.y, a1.y + a3.x);   // a1 + i a3
    }
    __syncthreads();
    float2* t = src; src = dst; dst = t;
  }

  // 3. Split step and power, bins 0..M, into the free buffer.
  float* s_pow = reinterpret_cast<float*>(dst);  // [FT][M + 1]
  const int n_bins = M + 1;
  for (int idx = tid; idx < FT * n_bins; idx += THREADS) {
    const int fi = idx / n_bins;
    const int k = idx - fi * n_bins;
    const float2* z = src + fi * M;
    const float2 zk = z[k & (M - 1)];
    const float2 zm = z[(M - k) & (M - 1)];
    // A = Z[k] + conj Z[M-k], D = Z[k] - conj Z[M-k]
    const float ar = zk.x + zm.x, ai = zk.y - zm.y;
    const float dr = zk.x - zm.x, di = zk.y + zm.y;
    const float2 cs = __ldg(tw + k);
    // X = A/2 - i (cos - i sin) D / 2
    const float xr = 0.5f * (ar + (cs.x * di - cs.y * dr));
    const float xi = 0.5f * (ai - (cs.x * dr + cs.y * di));
    s_pow[idx] = xr * xr + xi * xi;
  }
  __syncthreads();

  // 4-5. Banded mel and log, one (frame, mel) per thread.
  for (int idx = tid; idx < FT * n_mels; idx += THREADS) {
    const int fi = idx / n_mels;
    const int m = idx - fi * n_mels;
    const int f = f0 + fi;
    if (f >= n_frames) continue;
    const int first = __ldg(bands + 3 * m);
    const int count = __ldg(bands + 3 * m + 1);
    const int off = __ldg(bands + 3 * m + 2);
    const float* pw = s_pow + fi * n_bins + first;
    float acc = 0.f;
    for (int j = 0; j < count; ++j) {
      acc = fmaf(__ldg(weights + off + j), pw[j], acc);
    }
    out[((size_t)b * n_frames + f) * n_mels + m] = log1pf(acc + LOG_ZERO_GUARD);
  }
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it against
// the card's 227 KB per-block limit before launching).
extern "C" long long stft_mel_log_smem_bytes(int hop, int n_fft) {
  return (long long)smem_bytes(hop, n_fft);
}

// Launch on `stream`; returns a cudaError_t (0 on success). n_fft is a
// power of two in [64, 4096] (the wrapper checks). window [n_fft] f32;
// twiddles [n_fft] (cos, sin) f32 pairs; bands [n_mels, 3] int32 (first
// bin, count, offset into weights). Asynchronous: a fault during the run
// surfaces at the next synchronisation.
extern "C" int stft_mel_log_launch(const float* audio, int B, long long P,
                                   const float* window, const float* tw,
                                   int n_fft, const int* bands,
                                   const float* weights, int n_mels, int hop,
                                   int n_frames, float* out, void* stream) {
  static SmemLimit limit;
  const size_t smem = smem_bytes(hop, n_fft);
  int err = limit.raise_to(stft_mel_log_kernel, smem);
  if (err) return err;
  int log2_m = 0;
  while ((2 << log2_m) < n_fft) ++log2_m;
  const int ft = frames_per_block(n_fft);
  const dim3 grid((n_frames + ft - 1) / ft, B);
  stft_mel_log_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      audio, P, window, reinterpret_cast<const float2*>(tw), n_fft, log2_m,
      bands, weights, n_mels, hop, n_frames, out);
  return static_cast<int>(cudaGetLastError());
}
