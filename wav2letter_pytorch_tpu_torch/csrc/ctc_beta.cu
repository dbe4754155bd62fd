// K3: CTC backward (beta) recursion -> d(loss)/d log_probs.
//
// Replaces the Pallas TPU kernel wav2letter_pytorch_tpu/ops/ctc_pallas.py
// (_ctc_logz_bwd -> _beta_kernel), which walks time backwards over the
// alphas the forward stored and emits gamma = exp(alpha + beta - log Z) per
// lattice position; JAX then scatters gamma onto the labels. Here the
// scatter is the second of two launches. Inputs: batch-first log_probs
// [B, T, L] f32; the forward's alphas [B, T, N] f32, N = 2S+1 (K2,
// ctc_alpha.cu); nll [B] (= -log Z) and grad_nll [B] (the upstream
// gradient g_b of each row's nll) f32; logit_lengths [B], targets [B, S]
// (zero-padded), target_lengths [B] int32. Scratch: log-beta [B, T, N] f32
// and, per row, its label positions sorted by label with each label's
// offset, int32 [B, S + L + 1]. Output: grad [B, T, L] f32,
// grad[b, t, l] = -(g_b * sum over lattice positions s with label l of
// gamma_t(s)), and 0 at frames t >= logit_length.
//
// What bounds it on an H100: neither bytes nor FLOPs. At the main path
// (B=32, T ~ 404, L=29, S ~ 144) it reads ~15 MB of alphas and 1.5 MB of
// log-probs and writes 1.5 MB, ~5 us of memory traffic, and does a few tens
// of MFLOP. The limit, as for K2, is the chain of ~T dependent time steps:
// each step's betas need the next step's, and a label's update is two
// dependent logaddexps after a shuffle.
//
// Design: the gradient sums do not feed the recursion, so they leave the
// chain.
// (a) ctc_beta_chain_kernel: one block a row, the lattice in registers as
//     (blank, label) pairs as in K2 (ctc_lattice.cuh), walking DOWN from
//     the row's own logit_length - 1 (the TPU grid runs over the padded T
//     and re-masks padded frames as free blanks; a per-row loop needs
//     neither). It holds u_{t+1}[s] = beta_{t+1}[s] + log_probs[t+1, ext[s]]
//     and updates
//       blank 2k:   beta_t = logaddexp(u[2k], u[2k+1])
//       label 2k+1: beta_t = logaddexp(logaddexp(u[2k+1], u[2k+2]),
//                                      skip ? u[2k+3] : NEG_INF)
//     with u past the row's 2*S_b+1 positions at NEG_INF: pair k+1's blank
//     and label come by two shuffles (lane 31 from lane 0 of register j+1,
//     of register J-1 from the next warp's bottom pair through shared
//     memory). That is the plain version's nesting and rounding
//     (ops/ctc.py), whose second logaddexp at a blank is against NEG_INF
//     and adds exactly 0. Beta starts at 0 on the read positions 2*S_b and
//     2*S_b - 1 (the latter when S_b > 0: final_sel,
//     ctc_pallas.py:224-231). The frames arrive ahead of use in a cp.async
//     ring, read in descending order; log-beta is stored (not waited on)
//     for (b). Before the chain the block sorts the row's label positions
//     by label (a counting sort, stable, so each label's positions stay
//     ascending) while the first frames are in flight, and stores the
//     order for (b).
// (b) ctc_grad_kernel: fully parallel, one warp a (b, t) frame, 8 frames
//     of a row a block. A warp forms gamma = exp(alpha + beta - log Z) for
//     the row's positions (coalesced loads of alpha and beta) into shared
//     memory; the blank positions are summed by each lane in ascending s
//     and then by a butterfly over the lanes; lane l sums label l's
//     positions in the sorted order. Every sum has a fixed order and there
//     are no atomics, so the gradient is the same bits from run to run.
//     Frames at or past a row's length, and every frame of a row with
//     g_b == 0 (zero_infinity zeroed an impossible alignment, or a masked
//     padding row), get zeros: gamma, which overflows for an impossible
//     alignment, is never multiplied into 0 * inf, and (a) skips the row.
// The log-beta round trip is ~15 MB written and read at the main path
// (~10 us at 3.35 TB/s), against a chain of ~0.1 ms. The chain's step loop
// is unrolled by two.

#include <cuda_runtime.h>

#include "common.cuh"
#include "ctc_lattice.cuh"

namespace {

using ctc::CHUNK_FRAMES;
using ctc::FULL_MASK;
using ctc::MAX_WARPS;
using ctc::NEG_INF;
using ctc::RING_CHUNKS;

// (b)'s frames (warps) a block.
constexpr int GRAD_WARPS = 8;

// Chunk c of the chain's frames, in the order it reads them: steps
// i = c*F .. c*F+F-1 read frame t_last - i (i < t_last). The chunk's frames
// are one contiguous run, copied to its slot in ascending frame order:
// frame t_last - i sits at row F-1 - i%F of the slot.
__device__ __forceinline__ void load_chunk(float* ring, const float* lp,
                                           int L, int t_last, int c) {
  const int hi = t_last - c * CHUNK_FRAMES;
  const int lo_slot = hi - CHUNK_FRAMES + 1;
  const int lo = max(lo_slot, 0);
  if (hi >= 0) {
    ctc::cp_async_floats(ring + ((size_t)(c % RING_CHUNKS) * CHUNK_FRAMES +
                                 (lo - lo_slot)) * L,
                         lp + (size_t)lo * L, (hi - lo + 1) * L);
  }
  cp_async_commit();
}

template <int J>
__global__ void __launch_bounds__(ctc::max_threads(J))
    ctc_beta_chain_kernel(const float* __restrict__ log_probs, int T, int L,
                          const float* __restrict__ grad_nll,
                          const int* __restrict__ logit_lengths,
                          const int* __restrict__ targets, int S,
                          const int* __restrict__ target_lengths, int blank,
                          float* __restrict__ beta,
                          int* __restrict__ order) {
  extern __shared__ float smem[];
  float* ring = smem;
  // edge[buf][w][k]: warp w's u at its bottom pair's blank (k = 0) and
  // label (k = 1).
  float* edge = ring + ctc::ring_floats(L);
  int* s_tgt = reinterpret_cast<int*>(edge + 2 * 2 * MAX_WARPS);
  int* s_off = s_tgt + S;

  const int b = blockIdx.x;
  if (grad_nll[b] == 0.0f) return;  // (b) writes the row's zeros
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const bool multi = nwarps > 1;
  const int n_alloc = 2 * S + 1;
  // Clamped like an out-of-range gather in JAX: valid inputs are unchanged.
  const int tl = min(max(target_lengths[b], 0), S);
  const int n = 2 * tl + 1;
  // The forward seeds the lattice with frame 0 even for a zero length.
  const int t_end = max(min(logit_lengths[b], T), 1);
  const int t_last = t_end - 1;
  const float* lp = log_probs + (size_t)b * T * L;
  float* out = beta + (size_t)b * T * n_alloc;

  for (int c = 0; c < RING_CHUNKS; ++c) load_chunk(ring, lp, L, t_last, c);

  // Counting sort of the row's label positions by label, while the first
  // frames are in flight: order[b] = [positions (S) | offsets (L + 1)].
  int* perm = order + (size_t)b * (S + L + 1);
  int* off = perm + S;
  for (int i = tid; i < tl; i += nthreads) {
    s_tgt[i] = min(max(targets[(size_t)b * S + i], 0), L - 1);
  }
  __syncthreads();
  for (int l = tid; l < L; l += nthreads) {
    int count = 0;
    for (int i = 0; i < tl; ++i) count += s_tgt[i] == l;
    s_off[l] = count;
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int l = 0; l < L; ++l) {
      const int count = s_off[l];
      s_off[l] = o;
      off[l] = o;
      o += count;
    }
    off[L] = o;
  }
  __syncthreads();
  for (int l = tid; l < L; l += nthreads) {
    int k = s_off[l];
    for (int i = 0; i < tl; ++i) {
      if (s_tgt[i] == l) perm[k++] = 2 * i + 1;
    }
  }

  // Per pair: its label's index in a frame; whether the label may go on
  // to pair k+1's label (the two-step transition, between differing
  // labels).
  const int base = warp * 32 * J + lane;
  const int first = warp * 32 * J;  // the warp's first pair
  int lab[J];
  bool skip[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = base + 32 * j;
    lab[j] = k < tl ? s_tgt[k] : blank;
    skip[j] = k + 1 < tl && s_tgt[k + 1] != s_tgt[k];
  }

  cp_async_wait<RING_CHUNKS - 1>();  // chunk 0
  __syncthreads();

  // Step i = 0 is frame t_last: beta = 0 on the read positions.
  float ub[J], ul[J];  // u at the pair's blank and label
  bool keep_b[J], keep_l[J];  // stored: positions below 2*S_b + 1
  bool live[J];  // registers with pairs at most S_b; nothing reads the rest
  float* row = out + (size_t)t_last * n_alloc + 2 * base;  // lane's pairs
  {
    const float* frame = ring + (CHUNK_FRAMES - 1) * L;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = base + 32 * j;
      live[j] = first + 32 * j <= tl;
      keep_b[j] = 2 * k < n;
      keep_l[j] = 2 * k + 1 < n;
      const float bb = k == tl ? 0.0f : NEG_INF;
      const float bl = k == tl - 1 ? 0.0f : NEG_INF;
      if (keep_b[j]) row[64 * j] = bb;
      if (keep_l[j]) row[64 * j + 1] = bl;
      ub[j] = bb + frame[blank];
      ul[j] = bl + frame[lab[j]];
    }
  }
  // edge[parity * 2 * MAX_WARPS + 2 * w + k]: warp w's bottom pair's u
  // at its blank (k = 0) and label (k = 1) after a step.
  float* edge_out = edge + 2 * warp;
  const float* edge_in = edge + 2 * (warp + 1);
  if (multi && lane == 0) {
    edge_out[0] = ub[0];
    edge_out[1] = ul[0];
  }
  if (multi) __syncthreads();
  // Whether pair k's label and pair k+1's blank (u[2k+1], u[2k+2]) are
  // positions of the row.
  bool inner[J];
#pragma unroll
  for (int j = 0; j < J; ++j) inner[j] = base + 32 * j < tl;

#pragma unroll 2
  for (int i = 1; i <= t_last; ++i) {
    if (i % CHUNK_FRAMES == 0) {
      // Into the slot chunk i/F - 1 used: every read of it passed the
      // barrier at the end of step i-1.
      load_chunk(ring, lp, L, t_last, i / CHUNK_FRAMES + RING_CHUNKS - 1);
    }
    const int parity = (i & 1) * 2 * MAX_WARPS;
    // The next warp's bottom pair: u at positions 2*(first + 32*J) and +1.
    float nb_edge = NEG_INF, nl_edge = NEG_INF;
    if (warp + 1 < nwarps && lane == 31) {
      nb_edge = edge_in[parity ^ (2 * MAX_WARPS)];
      nl_edge = edge_in[(parity ^ (2 * MAX_WARPS)) + 1];
    }
    float rb[J], rl[J];  // pair k+1's blank and label, from lane + 1
#pragma unroll
    for (int j = 0; j < J; ++j) {
      rb[j] = __shfl_sync(FULL_MASK, ub[j], (lane + 1) & 31);
      rl[j] = __shfl_sync(FULL_MASK, ul[j], (lane + 1) & 31);
    }
    // Frame t_last - i: chunk i/F, row F-1 - i%F of its slot, which is
    // row (i ^ (F-1)) % (F * RING_CHUNKS) of the ring (F a power of two).
    const float* frame =
        ring + ((i ^ (CHUNK_FRAMES - 1)) % ctc::RING_FRAMES) * L;
    const float e_blank = frame[blank];
    row -= n_alloc;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!live[j]) continue;  // the same every step: no branch in the step
      const float nxb = lane <= 30 ? rb[j] : j < J - 1 ? rb[j + 1] : nb_edge;
      const float nxl = lane <= 30 ? rl[j] : j < J - 1 ? rl[j + 1] : nl_edge;
      // u[2k+3] where skip allows.
      const float bb = ctc::logaddexp(ub[j], inner[j] ? ul[j] : NEG_INF);
      if (keep_b[j]) row[64 * j] = bb;
      const float bl = ctc::logaddexp(
          ctc::logaddexp(ul[j], inner[j] ? nxb : NEG_INF),
          skip[j] ? nxl : NEG_INF);
      if (keep_l[j]) row[64 * j + 1] = bl;
      ub[j] = bb + e_blank;
      ul[j] = bl + frame[lab[j]];
    }
    if (multi && lane == 0) {
      edge_out[parity] = ub[0];
      edge_out[parity + 1] = ul[0];
    }
    const bool chunk_end = (i + 1) % CHUNK_FRAMES == 0;
    if (chunk_end) cp_async_wait<RING_CHUNKS - 2>();  // chunk of i+1
    if (multi) {
      __syncthreads();
    } else if (chunk_end) {
      __syncwarp();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * GRAD_WARPS)
    ctc_grad_kernel(int T, int L, const float* __restrict__ alphas,
                    const float* __restrict__ beta,
                    const float* __restrict__ nll,
                    const float* __restrict__ grad_nll,
                    const int* __restrict__ logit_lengths, int S,
                    const int* __restrict__ target_lengths, int blank,
                    const int* __restrict__ order, float* __restrict__ grad) {
  extern __shared__ float smem[];
  int* s_perm = reinterpret_cast<int*>(smem);
  int* s_off = s_perm + S;
  const int n_alloc = 2 * S + 1;
  float* gam = smem + S + L + 1 + (threadIdx.x >> 5) * n_alloc;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * GRAD_WARPS;
  const int t = t0 + (threadIdx.x >> 5);
  const float g = grad_nll[b];
  const int t_end = max(min(logit_lengths[b], T), 1);
  float* out = grad + ((size_t)b * T + t) * L;

  if (g == 0.0f || t0 >= t_end) {  // uniform over the block
    if (t < T) {
      for (int l = lane; l < L; l += 32) out[l] = 0.0f;
    }
    return;
  }
  const int tl = min(max(target_lengths[b], 0), S);
  const int n = 2 * tl + 1;
  const int* perm = order + (size_t)b * (S + L + 1);
  for (int k = threadIdx.x; k < tl; k += blockDim.x) s_perm[k] = perm[k];
  for (int l = threadIdx.x; l <= L; l += blockDim.x) s_off[l] = perm[S + l];
  __syncthreads();
  if (t >= T) return;
  if (t >= t_end) {
    for (int l = lane; l < L; l += 32) out[l] = 0.0f;
    return;
  }

  const float logz = -nll[b];
  const float* al = alphas + ((size_t)b * T + t) * n_alloc;
  const float* be = beta + ((size_t)b * T + t) * n_alloc;
  // Blank positions are the even s, so the even lanes (s = lane + 32k).
  float blank_part = 0.0f;
  for (int s = lane; s < n; s += 32) {
    const float gm = expf(al[s] + be[s] - logz);
    gam[s] = gm;
    if (!(s & 1)) blank_part += gm;
  }
  const float blank_sum = warp_sum(blank_part);  // the same on every lane
  __syncwarp();
  for (int l = lane; l < L; l += 32) {
    float sum = l == blank ? blank_sum : 0.0f;
    for (int k = s_off[l]; k < s_off[l + 1]; ++k) sum += gam[s_perm[k]];
    out[l] = -(g * sum);
  }
}

inline size_t chain_smem_bytes(int S, int L) {
  return (ctc::ring_floats(L) + 2 * 2 * MAX_WARPS) * sizeof(float) +
         ((size_t)S + L + 1) * sizeof(int);
}

inline size_t grad_smem_bytes(int S, int L) {
  return ((size_t)S + L + 1) * sizeof(int) +
         (size_t)GRAD_WARPS * (2 * S + 1) * sizeof(float);
}

template <int J>
int launch_chain(const float* log_probs, int B, int T, int L,
                 const float* grad_nll, const int* logit_lengths,
                 const int* targets, int S, const int* target_lengths,
                 int blank, float* beta, int* order, int warps,
                 cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(S, L);
  static SmemLimit limit;
  int err = limit.raise_to(ctc_beta_chain_kernel<J>, smem);
  if (err) return err;
  ctc_beta_chain_kernel<J><<<B, 32 * warps, smem, stream>>>(
      log_probs, T, L, grad_nll, logit_lengths, targets, S, target_lengths,
      blank, beta, order);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long ctc_beta_smem_bytes(int S, int L) {
  const size_t a = chain_smem_bytes(S, L), b = grad_smem_bytes(S, L);
  return (long long)(a > b ? a : b);
}

// Warps a row of the chain (a) for targets of width S (`warps` == 0: the
// table's choice); 0 when the design does not take S+1 pairs.
extern "C" int ctc_beta_warps(int S, int warps) {
  int j = 0;
  return ctc::plan_warps(S, warps, &j);
}

// Launch (a) then (b) on `stream`; returns a cudaError_t (0 on success).
// `beta` is a [B, T, 2S+1] f32 and `order` a [B, S + L + 1] int32 scratch
// buffer; `warps` == 0 takes the table's warps a row for (a).
extern "C" int ctc_beta_launch(const float* log_probs, int B, int T, int L,
                               const float* alphas, const float* nll,
                               const float* grad_nll,
                               const int* logit_lengths, const int* targets,
                               int S, const int* target_lengths, int blank,
                               float* grad, float* beta, int* order,
                               int warps, void* stream) {
  int j = 0;
  warps = ctc::plan_warps(S, warps, &j);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
#define CTC_CHAIN_LAUNCH(J)                                                  \
  err = launch_chain<J>(log_probs, B, T, L, grad_nll, logit_lengths,        \
                        targets, S, target_lengths, blank, beta, order,     \
                        warps, st)
  CTC_DISPATCH_J(j, CTC_CHAIN_LAUNCH)
#undef CTC_CHAIN_LAUNCH
  if (err) return err;
  const size_t smem = grad_smem_bytes(S, L);
  static SmemLimit limit;
  err = limit.raise_to(ctc_grad_kernel, smem);
  if (err) return err;
  const dim3 grid((T + GRAD_WARPS - 1) / GRAD_WARPS, B);
  ctc_grad_kernel<<<grid, 32 * GRAD_WARPS, smem, st>>>(
      T, L, alphas, beta, nll, grad_nll, logit_lengths, S, target_lengths,
      blank, order, grad);
  return static_cast<int>(cudaGetLastError());
}
