// K3: CTC backward (beta) recursion -> d(loss)/d log_probs.
//
// Replaces the Pallas TPU kernel wav2letter_pytorch_tpu/ops/ctc_pallas.py
// (_ctc_logz_bwd -> _beta_kernel), which walks time backwards over the
// alphas the forward stored and emits gamma = exp(alpha + beta - log Z) per
// lattice position; JAX then scatters gamma onto the labels. Here the
// scatter happens in the kernel. Inputs: batch-first log_probs [B, T, L]
// f32; the forward's alphas [B, T, N] f32, N = 2S+1 (K2, ctc_alpha.cu);
// nll [B] (= -log Z) and grad_nll [B] (the upstream gradient g_b of each
// row's nll) f32; logit_lengths [B], targets [B, S] (zero-padded),
// target_lengths [B] int32. Output: grad [B, T, L] f32,
// grad[b, t, l] = -g_b * sum over lattice positions s with label l of
// gamma_t(s), and 0 at frames t >= logit_length.
//
// What bounds it on an H100: neither bytes nor FLOPs. At the main path
// (B=32, T ~ 404, L=29, S ~ 144) it reads ~15 MB of alphas and 1.5 MB of
// log-probs and writes 1.5 MB, ~5 us of memory traffic, and does a few tens
// of MFLOP. The limit, as for K2, is the chain of ~T dependent time steps:
// each step's betas need the next step's.
//
// Design: one block per batch row, time a loop inside the block that runs
// DOWN from the row's own logit_length - 1 (the TPU grid runs over the
// padded T and re-masks padded frames as free blanks; a per-row loop needs
// neither, and gives the same result). Each thread owns lattice positions
// s = tid, tid + blockDim, ... below 2*S_b + 1. Beta starts at 0 on the
// read positions 2*S_b and 2*S_b - 1 (the latter when S_b > 0: final_sel,
// ctc_pallas.py:224-231) and is double-buffered in shared memory:
//   beta_t[s] = logaddexp(logaddexp(beta_{t+1}[s] + e_{t+1}(s),
//                                   beta_{t+1}[s+1] + e_{t+1}(s+1)),
//                         skip[s+2] ? beta_{t+1}[s+2] + e_{t+1}(s+2)
//                                   : NEG_INF)
// with emissions gathered from a shared copy of the row's L log-probs at
// t+1, prefetched one step ahead, as in K2. Each step then forms gamma from
// the stored alpha and sums it per label into a shared [L] accumulator
// (label positions by shared atomics; the blank positions, half the
// lattice, by a warp reduction first, so one atomic per warp hits the blank
// entry). The accumulator is double-buffered too, so a step needs one
// __syncthreads. The order of the atomics varies from run to run, so the
// sums may differ from the plain version in the last bits.
// A row with g_b == 0 (zero_infinity zeroed an impossible alignment, or a
// masked padding row) writes zeros and stops: gamma, which overflows for
// an impossible alignment, is never multiplied into 0 * inf.
// Arithmetic mirrors the plain version (ops/ctc.py::ctc_beta_reference):
// torch's logaddexp formula in the same nesting, NEG_INF = -1e30.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ inline float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void ctc_beta_kernel(const float* __restrict__ log_probs, int T,
                                int L, const float* __restrict__ alphas,
                                const float* __restrict__ nll,
                                const float* __restrict__ grad_nll,
                                const int* __restrict__ logit_lengths,
                                const int* __restrict__ targets, int S,
                                const int* __restrict__ target_lengths,
                                int blank, float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int n_alloc = 2 * S + 1;
  float* beta_buf[2] = {smem, smem + n_alloc};
  float* lp_buf[2] = {smem + 2 * n_alloc, smem + 2 * n_alloc + L};
  float* acc_buf[2] = {smem + 2 * n_alloc + 2 * L,
                       smem + 2 * n_alloc + 3 * L};
  int* s_tgt = reinterpret_cast<int*>(smem + 2 * n_alloc + 4 * L);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // Clamped like an out-of-range gather in JAX: valid inputs are unchanged.
  const int tl = min(max(target_lengths[b], 0), S);
  const int n = 2 * tl + 1;
  // The forward seeds the lattice with frame 0 even for a zero length.
  const int t_end = max(min(logit_lengths[b], T), 1);
  const int t_last = t_end - 1;
  const float g = grad_nll[b];
  float* out = grad + (size_t)b * T * L;

  // Frames past the row's length, or every frame of a row with g == 0.
  const size_t zero_from = g == 0.0f ? 0 : (size_t)t_end * L;
  for (size_t i = zero_from + tid; i < (size_t)T * L; i += nthreads) {
    out[i] = 0.0f;
  }
  if (g == 0.0f) return;  // uniform over the block: no barrier is skipped

  const float logz = -nll[b];
  const float neg_g = -g;
  const float* lp = log_probs + (size_t)b * T * L;
  const float* al = alphas + (size_t)b * T * n_alloc;

  for (int i = tid; i < S; i += nthreads) {
    s_tgt[i] = min(max(targets[(size_t)b * S + i], 0), L - 1);
  }
  for (int i = tid; i < L; i += nthreads) {
    acc_buf[0][i] = 0.0f;
    acc_buf[1][i] = 0.0f;
  }
  __syncthreads();

  for (int t = t_last; t >= 0; --t) {
    float* cur = beta_buf[t & 1];
    if (t == t_last) {
      for (int s = tid; s < n; s += nthreads) {
        cur[s] = (s == 2 * tl || (tl > 0 && s == 2 * tl - 1)) ? 0.0f
                                                              : NEG_INF;
      }
    } else {
      const float* nxt = beta_buf[(t + 1) & 1];
      const float* lp_n = lp_buf[(t + 1) & 1];
      for (int s = tid; s < n; s += nthreads) {
        const float u0 = nxt[s] + lp_n[(s & 1) ? s_tgt[s >> 1] : blank];
        float u1 = NEG_INF;
        if (s + 1 < n) {
          u1 = nxt[s + 1] + lp_n[((s + 1) & 1) ? s_tgt[(s + 1) >> 1] : blank];
        }
        float u2 = NEG_INF;
        // skip[s+2]: s+2 is a label position whose label differs from the
        // previous label (s odd, s+2 >= 3).
        if (s + 2 < n && (s & 1)) {
          const int lab = s_tgt[(s + 2) >> 1];
          if (lab != s_tgt[s >> 1]) u2 = nxt[s + 2] + lp_n[lab];
        }
        cur[s] = logaddexp(logaddexp(u0, u1), u2);
      }
    }
    // Prefetch frame t into the buffer frame t+2 used (its readers passed
    // the previous step's barrier); step t-1 reads it.
    if (t > 0) {
      float* lp_t = lp_buf[t & 1];
      for (int i = tid; i < L; i += nthreads) lp_t[i] = lp[(size_t)t * L + i];
    }
    float* acc = acc_buf[t & 1];
    float blank_part = 0.0f;
    for (int s = tid; s < n; s += nthreads) {
      const float gm = expf(al[(size_t)t * n_alloc + s] + cur[s] - logz);
      if (s & 1) {
        atomicAdd(&acc[s_tgt[s >> 1]], gm);
      } else {
        blank_part += gm;
      }
    }
    blank_part = warp_sum(blank_part);
    if ((tid & 31) == 0 && blank_part != 0.0f) atomicAdd(&acc[blank], blank_part);
    __syncthreads();
    // Write this frame and clear its accumulator; the next step sums into
    // the other one, cleared two steps ago.
    for (int l = tid; l < L; l += nthreads) {
      out[(size_t)t * L + l] = neg_g * acc[l];
      acc[l] = 0.0f;
    }
  }
}

inline size_t smem_bytes(int S, int L) {
  return (2 * (size_t)(2 * S + 1) + 4 * (size_t)L) * sizeof(float) +
         (size_t)S * sizeof(int);
}

}  // namespace

extern "C" long long ctc_beta_smem_bytes(int S, int L) {
  return (long long)smem_bytes(S, L);
}

// Launch on `stream`; returns a cudaError_t (0 on success).
extern "C" int ctc_beta_launch(const float* log_probs, int B, int T, int L,
                               const float* alphas, const float* nll,
                               const float* grad_nll,
                               const int* logit_lengths, const int* targets,
                               int S, const int* target_lengths, int blank,
                               float* grad, void* stream) {
  const size_t smem = smem_bytes(S, L);
  static SmemLimit limit;
  int err = limit.raise_to(ctc_beta_kernel, smem);
  if (err) return err;
  int threads = ((2 * S + 1) + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  ctc_beta_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, T, L, alphas, nll, grad_nll, logit_lengths, targets, S,
      target_lengths, blank, grad);
  return static_cast<int>(cudaGetLastError());
}
