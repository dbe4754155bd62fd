// K1: fused framing -> windowed real DFT -> power -> mel -> log1p(+2^-24).
//
// Replaces the Pallas TPU kernel wav2letter_pytorch_tpu/ops/stft_pallas.py
// (stft_mel_log_pallas -> _kernel). Input: centre-padded audio [B, P] f32;
// output: log-mel [B, n_frames, n_mels] f32, where frame f covers samples
// [f*hop, f*hop + n_fft) of its row.
//
// What bounds it on an H100: operations. At the main path (B=32, 808
// frames, n_fft 512, 257 bins, 64 mels) the DFT is about 14 GFLOP of FP32
// FMA against about 23 MB of input and output, so the FP32 (non-tensor-
// core) rate, not memory, is the limit. TF32 tensor cores would be faster
// but keep about three decimal digits, which the spectral power cannot
// afford (the JAX package runs these products at HIGHEST precision).
//
// Design: one block per (batch row, tile of TF frames). The block copies
// its contiguous audio span, (TF-1)*hop + n_fft samples, into shared
// memory once; frames are overlapping views of it, so the TPU kernel's
// hop-aligned q-decomposition is not needed. Bins go in chunks of NB: for
// each chunk the block accumulates re and im for its TF frames over n_fft
// in KC-sample steps, with the DFT basis chunk staged in shared memory
// (the 2 x 512 x 257 f32 bases, about 1 MB, stay in L2 across blocks),
// squares them into power, and adds power_chunk @ fb[chunk] into a mel
// tile in shared memory. Mel is linear in power, so nothing but the
// [TF, n_mels] log-mel tile is ever written. All arithmetic is FP32 FMA.
// A simple first version: no tensor cores, no cp.async pipelining.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TF = 32;       // frames per block
constexpr int NB = 32;       // DFT bins per chunk
constexpr int KC = 32;       // samples per basis chunk
constexpr int THREADS = 128; // 8 frame groups x 16 bin groups
constexpr int FPT = 4;       // frames per thread (8 groups x 4 = TF)
constexpr float LOG_ZERO_GUARD = 5.9604644775390625e-08f;  // 2^-24

static_assert(THREADS == (TF / FPT) * (NB / 2), "thread layout");

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline size_t smem_floats(int hop, int n_fft,
                                              int n_mels) {
  const int span = (TF - 1) * hop + round_up(n_fft, KC);
  return (size_t)span + 2 * KC * NB + TF * NB + NB * n_mels + TF * n_mels;
}

__global__ void __launch_bounds__(THREADS)
stft_mel_log_kernel(const float* __restrict__ audio, long long P,
                    const float* __restrict__ dft_re,
                    const float* __restrict__ dft_im, int n_fft, int n_bins,
                    const float* __restrict__ fb, int n_mels, int hop,
                    int n_frames, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n_fft_pad = round_up(n_fft, KC);
  const int span = (TF - 1) * hop + n_fft_pad;
  float* s_audio = smem;               // [span]
  float* s_re = s_audio + span;        // [KC, NB]
  float* s_im = s_re + KC * NB;        // [KC, NB]
  float* s_pow = s_im + KC * NB;       // [TF, NB]
  float* s_fb = s_pow + TF * NB;       // [NB, n_mels]
  float* s_mel = s_fb + NB * n_mels;   // [TF, n_mels]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TF;
  const int tid = threadIdx.x;
  const float* x = audio + (size_t)b * P;
  const long long start = (long long)f0 * hop;
  for (int i = tid; i < span; i += THREADS) {
    const long long p = start + i;
    s_audio[i] = p < P ? x[p] : 0.f;
  }
  for (int i = tid; i < TF * n_mels; i += THREADS) s_mel[i] = 0.f;

  const int fg = tid / (NB / 2);  // frames fg*FPT .. fg*FPT + FPT-1
  const int bg = tid % (NB / 2);  // bins bg and bg + NB/2 of the chunk

  for (int c0 = 0; c0 < n_bins; c0 += NB) {
    float re[FPT][2], im[FPT][2];
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      re[i][0] = re[i][1] = im[i][0] = im[i][1] = 0.f;
    }
    for (int k0 = 0; k0 < n_fft_pad; k0 += KC) {
      __syncthreads();  // previous readers of s_re/s_im (and s_pow/s_fb)
      for (int i = tid; i < KC * NB; i += THREADS) {
        const int k = k0 + i / NB, bin = c0 + i % NB;
        const bool ok = k < n_fft && bin < n_bins;
        s_re[i] = ok ? dft_re[(size_t)k * n_bins + bin] : 0.f;
        s_im[i] = ok ? dft_im[(size_t)k * n_bins + bin] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float wr0 = s_re[kk * NB + bg];
        const float wr1 = s_re[kk * NB + bg + NB / 2];
        const float wi0 = s_im[kk * NB + bg];
        const float wi1 = s_im[kk * NB + bg + NB / 2];
#pragma unroll
        for (int i = 0; i < FPT; ++i) {
          const float a = s_audio[(fg * FPT + i) * hop + k0 + kk];
          re[i][0] = fmaf(a, wr0, re[i][0]);
          re[i][1] = fmaf(a, wr1, re[i][1]);
          im[i][0] = fmaf(a, wi0, im[i][0]);
          im[i][1] = fmaf(a, wi1, im[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      const int f = fg * FPT + i;
      s_pow[f * NB + bg] = re[i][0] * re[i][0] + im[i][0] * im[i][0];
      s_pow[f * NB + bg + NB / 2] = re[i][1] * re[i][1] + im[i][1] * im[i][1];
    }
    for (int i = tid; i < NB * n_mels; i += THREADS) {
      const int bin = c0 + i / n_mels;
      s_fb[i] = bin < n_bins ? fb[(size_t)bin * n_mels + i % n_mels] : 0.f;
    }
    __syncthreads();
    // Each thread owns the same mel elements in every chunk: no races.
    for (int i = tid; i < TF * n_mels; i += THREADS) {
      const int f = i / n_mels, m = i % n_mels;
      float acc = s_mel[i];
#pragma unroll 8
      for (int j = 0; j < NB; ++j) {
        acc = fmaf(s_pow[f * NB + j], s_fb[j * n_mels + m], acc);
      }
      s_mel[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < TF * n_mels; i += THREADS) {
    const int f = f0 + i / n_mels;
    if (f < n_frames) {
      out[((size_t)b * n_frames + f) * n_mels + i % n_mels] =
          log1pf(s_mel[i] + LOG_ZERO_GUARD);
    }
  }
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it against
// the card's 227 KB per-block limit before launching).
extern "C" long long stft_mel_log_smem_bytes(int hop, int n_fft,
                                             int n_mels) {
  return (long long)(smem_floats(hop, n_fft, n_mels) * sizeof(float));
}

// Launch on `stream`; returns a cudaError_t (0 on success). Asynchronous:
// a fault during the run surfaces at the next synchronisation.
extern "C" int stft_mel_log_launch(const float* audio, int B, long long P,
                                   const float* dft_re, const float* dft_im,
                                   int n_fft, int n_bins, const float* fb,
                                   int n_mels, int hop, int n_frames,
                                   float* out, void* stream) {
  const size_t smem = smem_floats(hop, n_fft, n_mels) * sizeof(float);
  int err = set_smem_limit(stft_mel_log_kernel, smem);
  if (err) return err;
  const dim3 grid((n_frames + TF - 1) / TF, B);
  stft_mel_log_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      audio, P, dft_re, dft_im, n_fft, n_bins, fb, n_mels, hop, n_frames,
      out);
  return static_cast<int>(cudaGetLastError());
}
