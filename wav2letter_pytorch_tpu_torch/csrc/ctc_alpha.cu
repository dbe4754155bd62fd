// K2: CTC forward (alpha) recursion in log space -> per-sample -log Z,
// and optionally every step's alphas for the backward (K3, ctc_beta.cu).
//
// Replaces the Pallas TPU kernel wav2letter_pytorch_tpu/ops/ctc_pallas.py
// (_alpha_pass -> _alpha_kernel). Inputs: batch-first log_probs [B, T, L]
// f32, logit_lengths [B], targets [B, S] (zero-padded) and target_lengths
// [B], all int32. Outputs: nll [B] f32, before zero_infinity and reduction
// (the wrapper applies those); with STORE, the alphas [B, T, N] f32,
// N = 2S+1, which the TPU kernel also keeps as the backward's residual
// (ctc_pallas.py:153-156). Only the entries the backward reads are
// written: rows t < the row's logit_length, positions s < 2*S_b+1; the
// rest of the buffer is left as allocated. Evaluation instantiates the
// kernel without STORE and writes nothing but nll.
//
// What bounds it on an H100: neither bytes nor FLOPs. The inputs are about
// 1.5 MB at the main path (B=32, T ~ 404, L=29), well under a microsecond
// of memory traffic, and the lattice updates are a few tens of MFLOP;
// storing the alphas adds ~15 MB of writes (~5 us). The limit is the chain
// of ~T dependent time steps: a label's update is two dependent logaddexps
// of ~30 instructions each (exp, then log1p's polynomial), and the warps
// of a row share one SM's four schedulers, two warps on one of them once a
// row has more than 128 pairs.
//
// Design (ctc_lattice.cuh): one block a row, the lattice in registers as
// (blank, label) pairs, pair k = w*32*J + 32*j + lane. A step updates
//   blank 2k:   logaddexp(alpha[2k], alpha[2k-1]) + lp[t, blank]
//   label 2k+1: logaddexp(logaddexp(alpha[2k+1], alpha[2k]),
//                         skip ? alpha[2k-1] : NEG_INF) + lp[t, label k]
// where alpha[2k-1] is pair k-1's label: one shuffle a register (lane 0
// from lane 31 of register j-1, of register 0 from the previous warp's top
// label through shared memory). That is the plain version's nesting and
// rounding (ops/ctc.py): its second logaddexp at a blank is against
// NEG_INF, which adds exactly 0, so the kernel leaves it out. Nothing on
// the chain reads device memory: the frames arrive ahead of use in a
// cp.async ring, and the gather of ext[s] is a shared-memory load whose
// address is fixed per row. The stores of alphas are not waited on. One
// warp a row has no barrier; several have one __syncthreads a step (a
// block is one row, so it is the row's barrier). The TPU's sequential time
// grid becomes a loop to the row's own logit_length, so the TPU kernel's
// re-masking of padded frames as free blanks is not needed. Pairs past the
// row's 2*S_b+1 positions never feed a lower position and are not stored;
// a register whose pairs all lie there is not updated. The step loop is
// unrolled by two.

#include <cuda_runtime.h>

#include "common.cuh"
#include "ctc_lattice.cuh"

namespace {

using ctc::CHUNK_FRAMES;
using ctc::FULL_MASK;
using ctc::MAX_WARPS;
using ctc::NEG_INF;
using ctc::RING_CHUNKS;

// Chunk c of the row's frames (frames c*F .. c*F+F-1 below t_end) into its
// ring slot, as one commit group (empty past t_end).
__device__ __forceinline__ void load_chunk(float* ring, const float* lp,
                                           int L, int t_end, int c) {
  const int lo = c * CHUNK_FRAMES;
  const int frames = min(CHUNK_FRAMES, t_end - lo);
  if (frames > 0) {
    ctc::cp_async_floats(ring + (size_t)(c % RING_CHUNKS) * CHUNK_FRAMES * L,
                         lp + (size_t)lo * L, frames * L);
  }
  cp_async_commit();
}

template <int J, bool STORE>
__global__ void __launch_bounds__(ctc::max_threads(J))
    ctc_alpha_kernel(const float* __restrict__ log_probs, int T, int L,
                     const int* __restrict__ logit_lengths,
                     const int* __restrict__ targets, int S,
                     const int* __restrict__ target_lengths, int blank,
                     float* __restrict__ nll, float* __restrict__ alphas) {
  extern __shared__ float smem[];
  float* ring = smem;
  // edge[buf][w]: warp w's top label.
  float* edge = ring + ctc::ring_floats(L);
  float* fin = edge + 2 * MAX_WARPS;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool multi = blockDim.x > 32;
  const int n_alloc = 2 * S + 1;
  // Clamped like an out-of-range gather in JAX: valid inputs are unchanged.
  const int tl = min(max(target_lengths[b], 0), S);
  const int n = 2 * tl + 1;
  // Frame 0 always seeds the lattice; steps 1 .. t_end-1 follow.
  const int t_end = max(min(logit_lengths[b], T), 1);
  const float* lp = log_probs + (size_t)b * T * L;
  float* out = STORE ? alphas + (size_t)b * T * n_alloc : nullptr;

  for (int c = 0; c < RING_CHUNKS; ++c) load_chunk(ring, lp, L, t_end, c);

  // Per pair: its label's index in a frame, and whether the label may be
  // entered from the previous label (the two-step transition, only between
  // differing labels).
  const int base = warp * 32 * J + lane;
  const int first = warp * 32 * J;  // the warp's first pair
  int lab[J];
  bool skip[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = base + 32 * j;
    lab[j] = blank;
    skip[j] = false;
    if (k < tl) {
      lab[j] = min(max(targets[(size_t)b * S + k], 0), L - 1);
      if (k >= 1) {
        skip[j] = lab[j] != min(max(targets[(size_t)b * S + k - 1], 0), L - 1);
      }
    }
  }

  cp_async_wait<RING_CHUNKS - 1>();  // chunk 0
  __syncthreads();

  float ab[J], al[J];  // alpha at the pair's blank and label
  bool keep_b[J], keep_l[J];  // stored: positions below 2*S_b + 1
  bool live[J];  // registers with pairs at most S_b; nothing reads the rest
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = base + 32 * j;
    live[j] = first + 32 * j <= tl;
    keep_b[j] = 2 * k < n;
    keep_l[j] = 2 * k + 1 < n;
    ab[j] = k == 0 ? ring[blank] : NEG_INF;
    al[j] = k == 0 && tl > 0 ? ring[lab[j]] : NEG_INF;
    if (STORE && keep_b[j]) out[2 * k] = ab[j];
    if (STORE && keep_l[j]) out[2 * k + 1] = al[j];
  }
  // edge[parity * MAX_WARPS + w]: warp w's top label after a step.
  float* edge_out = edge + warp;
  const float* edge_in = edge + warp - 1;
  if (multi && lane == 31) edge_out[0] = al[J - 1];
  if (multi) __syncthreads();

  float* row = STORE ? out + 2 * base : nullptr;  // lane's pairs, alphas[t]
#pragma unroll 2
  for (int t = 1; t < t_end; ++t) {
    if (t % CHUNK_FRAMES == 0) {
      // Into the slot chunk t/F - 1 used: every read of it passed the
      // barrier at the end of step t-1.
      load_chunk(ring, lp, L, t_end, t / CHUNK_FRAMES + RING_CHUNKS - 1);
    }
    const float* frame = ring + (t % ctc::RING_FRAMES) * L;
    const float e_blank = frame[blank];
    const int parity = (t & 1) * MAX_WARPS;
    // The previous warp's top label: alpha at position 2*first - 1.
    const float e_prev = warp > 0 && lane == 0
                             ? edge_in[parity ^ MAX_WARPS]
                             : NEG_INF;
    float r[J];  // pair k-1's label, from lane - 1
#pragma unroll
    for (int j = 0; j < J; ++j) {
      r[j] = __shfl_sync(FULL_MASK, al[j], (lane + 31) & 31);
    }
    if (STORE) row += n_alloc;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!live[j]) continue;  // the same every step: no branch in the step
      const float prev = lane >= 1 ? r[j] : j > 0 ? r[j - 1] : e_prev;
      const float nb = ctc::logaddexp(ab[j], prev) + e_blank;
      if (STORE && keep_b[j]) row[64 * j] = nb;
      al[j] = ctc::logaddexp(ctc::logaddexp(al[j], ab[j]),
                             skip[j] ? prev : NEG_INF) +
              frame[lab[j]];
      ab[j] = nb;
      if (STORE && keep_l[j]) row[64 * j + 1] = al[j];
    }
    if (multi && lane == 31) edge_out[parity] = al[J - 1];
    const bool chunk_end = (t + 1) % CHUNK_FRAMES == 0;
    if (chunk_end) cp_async_wait<RING_CHUNKS - 2>();  // chunk of t+1
    if (multi) {
      __syncthreads();
    } else if (chunk_end) {
      __syncwarp();
    }
  }

  cp_async_wait<0>();  // no copy outlives the block
  // -log Z from the final blank (2*S_b) and, for S_b > 0, the final label.
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = base + 32 * j;
    if (k == tl) fin[0] = ab[j];
    if (k == tl - 1) fin[1] = al[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    nll[b] = -ctc::logaddexp(fin[0], tl > 0 ? fin[1] : NEG_INF);
  }
}

// Counts the floats x in [0, 1] (every bit pattern from 0 to 1.0f) where
// ctc::log1p_unit(x) and log1pf(x) differ in any bit.
__global__ void log1p_check_kernel(unsigned long long* mismatches) {
  const unsigned top = 0x3f800000u;
  unsigned long long count = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i <= top;
       i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(i);
    count += __float_as_uint(ctc::log1p_unit(x)) != __float_as_uint(log1pf(x));
  }
  if (count) atomicAdd(mismatches, count);
}

inline size_t smem_bytes(int L) {
  return (ctc::ring_floats(L) + 2 * MAX_WARPS + 2) * sizeof(float);
}

template <int J, bool STORE>
int launch(const float* log_probs, int B, int T, int L,
           const int* logit_lengths, const int* targets, int S,
           const int* target_lengths, int blank, float* nll, float* alphas,
           int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(L);
  static SmemLimit limit;
  int err = limit.raise_to(ctc_alpha_kernel<J, STORE>, smem);
  if (err) return err;
  ctc_alpha_kernel<J, STORE><<<B, 32 * warps, smem, stream>>>(
      log_probs, T, L, logit_lengths, targets, S, target_lengths, blank, nll,
      alphas);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long ctc_alpha_smem_bytes(int S, int L) {
  (void)S;
  return (long long)smem_bytes(L);
}

// The number of floats in [0, 1] where the kernels' log1p differs from
// log1pf (0 when they agree bit for bit), or -1 - a cudaError_t. Runs on
// `stream` and waits for it.
extern "C" long long ctc_log1p_mismatches(void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* d = nullptr;
  unsigned long long h = 0;
  cudaError_t err = cudaMallocAsync(&d, sizeof(h), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(d, 0, sizeof(h), st);
  if (err == cudaSuccess) {
    log1p_check_kernel<<<1056, 256, 0, st>>>(d);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(&h, d, sizeof(h), cudaMemcpyDeviceToHost, st);
  }
  if (d) cudaFreeAsync(d, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  return err == cudaSuccess ? (long long)h : -1 - (long long)err;
}

// Warps a row the launch uses for targets of width S (`warps` == 0: the
// table's choice); 0 when the design does not take S+1 pairs.
extern "C" int ctc_alpha_warps(int S, int warps) {
  int j = 0;
  return ctc::plan_warps(S, warps, &j);
}

// Launch on `stream`; returns a cudaError_t (0 on success). `alphas` is
// null (evaluation) or a [B, T, 2S+1] f32 buffer (training). `warps` == 0
// takes the table's warps a row.
extern "C" int ctc_alpha_launch(const float* log_probs, int B, int T, int L,
                                const int* logit_lengths, const int* targets,
                                int S, const int* target_lengths, int blank,
                                float* nll, float* alphas, int warps,
                                void* stream) {
  int j = 0;
  warps = ctc::plan_warps(S, warps, &j);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CTC_ALPHA_LAUNCH(J)                                                  \
  return alphas ? launch<J, true>(log_probs, B, T, L, logit_lengths,        \
                                  targets, S, target_lengths, blank, nll,   \
                                  alphas, warps, st)                        \
                : launch<J, false>(log_probs, B, T, L, logit_lengths,       \
                                   targets, S, target_lengths, blank, nll,  \
                                   alphas, warps, st)
  CTC_DISPATCH_J(j, CTC_ALPHA_LAUNCH)
#undef CTC_ALPHA_LAUNCH
  return 0;
}
