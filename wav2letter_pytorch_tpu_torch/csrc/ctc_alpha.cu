// K2: CTC forward (alpha) recursion in log space -> per-sample -log Z,
// and optionally every step's alphas for the backward (K3, ctc_beta.cu).
//
// Replaces the Pallas TPU kernel wav2letter_pytorch_tpu/ops/ctc_pallas.py
// (_alpha_pass -> _alpha_kernel). Inputs: batch-first log_probs [B, T, L]
// f32, logit_lengths [B], targets [B, S] (zero-padded) and target_lengths
// [B], all int32. Outputs: nll [B] f32, before zero_infinity and reduction
// (the wrapper applies those); with a non-null `alphas`, the alphas
// [B, T, N] f32, N = 2S+1, which the TPU kernel also keeps as the
// backward's residual (ctc_pallas.py:153-156). Only the entries the
// backward reads are written: rows t < the row's logit_length, positions
// s < 2*S_b+1; the rest of the buffer is left as allocated. Evaluation
// passes null and writes nothing but nll.
//
// What bounds it on an H100: neither bytes nor FLOPs. The inputs are about
// 1.5 MB at the main path (B=32, T ~ 404, L=29), well under a microsecond
// of memory traffic, and the lattice updates are a few tens of MFLOP;
// storing the alphas adds ~15 MB of writes (~5 us). The limit is the chain
// of ~T dependent time steps, each a logaddexp over the previous step's
// alphas: a latency chain, one barrier per step.
//
// Design: one block per batch row; each thread owns lattice positions
// s = tid, tid + blockDim, ... of the extended label sequence (length
// 2*S_b + 1 for the row's own target length S_b; later positions never feed
// the read positions). The alpha row is double-buffered in shared memory,
// so a step needs one __syncthreads. The TPU's sequential time grid becomes
// a loop inside the block that runs to the row's own logit_length, so the
// TPU kernel's re-masking of padded frames as free blanks is not needed.
// The emission gather log_probs[b, t, ext[s]] happens here, from a
// shared-memory copy of the row's L log-probs at step t, prefetched one
// step ahead; the [T, B, N] emission tensor the JAX path builds is never
// materialised. Arithmetic mirrors the plain version: logaddexp(logaddexp(a,
// s1), s2) with torch's logaddexp formula and NEG_INF = -1e30.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ inline float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs, int T,
                                 int L,
                                 const int* __restrict__ logit_lengths,
                                 const int* __restrict__ targets, int S,
                                 const int* __restrict__ target_lengths,
                                 int blank, float* __restrict__ nll,
                                 float* __restrict__ alphas) {
  extern __shared__ float smem[];
  const int n_alloc = 2 * S + 1;
  float* alpha_buf[2] = {smem, smem + n_alloc};
  float* lp_buf[2] = {smem + 2 * n_alloc, smem + 2 * n_alloc + L};
  int* s_tgt = reinterpret_cast<int*>(smem + 2 * n_alloc + 2 * L);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // Clamped like an out-of-range gather in JAX: valid inputs are unchanged.
  const int tl = min(max(target_lengths[b], 0), S);
  const int n = 2 * tl + 1;
  // Frame 0 always seeds the lattice; steps 1 .. t_end-1 follow.
  const int t_end = max(min(logit_lengths[b], T), 1);
  const float* lp = log_probs + (size_t)b * T * L;
  float* alpha_out = alphas ? alphas + (size_t)b * T * n_alloc : nullptr;

  for (int i = tid; i < S; i += nthreads) {
    s_tgt[i] = min(max(targets[(size_t)b * S + i], 0), L - 1);
  }
  for (int i = tid; i < L; i += nthreads) {
    lp_buf[0][i] = lp[i];
    if (t_end > 1) lp_buf[1][i] = lp[(size_t)L + i];
  }
  __syncthreads();
  for (int s = tid; s < n; s += nthreads) {
    float a = NEG_INF;
    if (s == 0) a = lp_buf[0][blank];
    if (s == 1) a = lp_buf[0][s_tgt[0]];
    alpha_buf[0][s] = a;
    if (alpha_out) alpha_out[s] = a;
  }
  __syncthreads();

  for (int t = 1; t < t_end; ++t) {
    const float* prev = alpha_buf[(t - 1) & 1];
    float* cur = alpha_buf[t & 1];
    const float* lp_t = lp_buf[t & 1];
    // Prefetch step t+1 into the buffer step t-1 used (all its readers
    // passed the previous barrier).
    if (t + 1 < t_end) {
      float* lp_next = lp_buf[(t + 1) & 1];
      for (int i = tid; i < L; i += nthreads) {
        lp_next[i] = lp[(size_t)(t + 1) * L + i];
      }
    }
    for (int s = tid; s < n; s += nthreads) {
      const bool is_label = s & 1;
      const int label = is_label ? s_tgt[s >> 1] : blank;
      const float s1 = s >= 1 ? prev[s - 1] : NEG_INF;
      const bool skip = is_label && s >= 3 && label != s_tgt[(s >> 1) - 1];
      const float s2 = skip ? prev[s - 2] : NEG_INF;
      const float a = logaddexp(logaddexp(prev[s], s1), s2) + lp_t[label];
      cur[s] = a;
      if (alpha_out) alpha_out[(size_t)t * n_alloc + s] = a;
    }
    __syncthreads();
  }

  if (tid == 0) {
    const float* fin = alpha_buf[(t_end - 1) & 1];
    const float a_blank = fin[2 * tl];
    const float a_label = tl > 0 ? fin[2 * tl - 1] : NEG_INF;
    nll[b] = -logaddexp(a_blank, a_label);
  }
}

inline size_t smem_bytes(int S, int L) {
  return (2 * (size_t)(2 * S + 1) + 2 * (size_t)L) * sizeof(float) +
         (size_t)S * sizeof(int);
}

}  // namespace

extern "C" long long ctc_alpha_smem_bytes(int S, int L) {
  return (long long)smem_bytes(S, L);
}

// Launch on `stream`; returns a cudaError_t (0 on success). `alphas` is
// null (evaluation) or a [B, T, 2S+1] f32 buffer (training).
extern "C" int ctc_alpha_launch(const float* log_probs, int B, int T, int L,
                                const int* logit_lengths, const int* targets,
                                int S, const int* target_lengths, int blank,
                                float* nll, float* alphas, void* stream) {
  const size_t smem = smem_bytes(S, L);
  int err = set_smem_limit(ctc_alpha_kernel, smem);
  if (err) return err;
  int threads = ((2 * S + 1) + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, T, L, logit_lengths, targets, S, target_lengths, blank, nll,
      alphas);
  return static_cast<int>(cudaGetLastError());
}
