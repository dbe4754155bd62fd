// K4 and K5: depthwise 1-D convolution, forward and weight gradient.
//
// Replaces the Pallas TPU kernels of wav2letter_pytorch_tpu/ops/
// depthwise_pallas.py: K4 is _dw_pallas -> _dw_fma_kernel,
//     y[b, t, c] = sum_k w[k, c] * x_pad[b, t*s + k*d, c],
// x [B, T, C], w [K, C], stride s, dilation d, symmetric zero padding p,
// y [B, T_out, C], T_out = (T + 2p - d(K-1) - 1) / s + 1; K5 is
// _dw_pallas_wgrad -> _dw_wgrad_kernel,
//     dw[k, c] = sum_{b, t} x_pad[b, t*s + k*d, c] * g[b, t, c].
// Elements are float32, or bfloat16 (model.compute_dtype=bf16; the TPU
// kernel's "bf16 in -> bf16 out, f32 accumulate"): every kernel is a
// template on the element type E, staged in shared memory as E (half the
// bytes at bf16), summed in float32 and, for K4, written as E rounded to
// nearest even; K5's partials and dw are float32 either way (the wrapper
// rounds a bf16 dw, as _dw_op_bwd's dw.astype(w.dtype)).
// The input gradient is K4 again (stride 1, flipped w, on the zero-stuffed
// cotangent), as in _dw_op_bwd; the wrapper (ops/depthwise.py) arranges it.
//
// What bounds them on an H100: bytes. K taps of one FMA per element read
// is 2K operations per 8 bytes moved (x read, y written): at K = 33 that is
// ~8 FLOP/byte, under the card's ~20 FLOP/byte FP32 balance point (67
// TFLOP/s over 3.35 TB/s). The QuartzNet layer (C1: B=32, T=808, C=64,
// stride 2) moves ~10 MB, ~3 us. In practice both are short one-wave
// kernels whose staging, shared-memory-fed FMAs and stores run one after
// the other in every block (PERF.md, the K4/K5 findings).
//
// Phase planes, as the TPU kernel's _phase_views: a block stages its span
// of x_pad (zero outside [0, T): the padding) in shared memory as s
// stride-1 planes, plane r row i = x_pad[u0 + i*s + r], so tap k reads
// plane (k d) mod s at row t + (k d) div s, one row a frame. With
// g = gcd(s, d), s' = s/g and d' = d/g, the taps k = kr, kr + s', kr + 2s',
// ... (a class, kr < s') share a plane and sit d' rows apart. Copies are
// cp.async, 16 bytes where C is a multiple of 16 bytes' elements (4 f32, 8
// bf16) and the bases are aligned, else one element (bf16: a plain load).
// A shared row holds a block's CT = 32 channels. A lane owns two of them
// (a float2 or a bf16 pair: with one 32-bit shared load per R FMAs the
// loads' issue rate, not the FMAs', was the limit, and a 64-bit load moves
// twice the bytes for one issue), so a half-warp reads a whole row and
// each half-warp works on an item of its own.
//
// K4: a block per (time tile, 32 channels, batch row). A thread computes R
// outputs of its channels, frames f0 + i d' (i < R). For the taps of one
// class, the x values are V[m] = plane[f0 + o + m d'] (o the class's first
// row): tap j of the class needs V[j .. j+R-1], a register window that
// slides by one from one tap to the next. So a tap costs one shared load of
// x, one of w and R independent FMAs a channel. The taps are summed class
// by class.
//
// K5: a block per (32 channels, time chunk, batch row), so C1 fills the
// card (2 x 4 x 32 = 256 blocks). A thread owns a group of up to R
// consecutive taps of one class and a slice of the chunk's frames (fa,
// fa + d', ...): over them it keeps the x values its taps need in a
// register window that slides one row a frame, so a frame costs one shared
// load of x, one of g and R independent FMAs a channel. Its sums go to
// shared memory (each entry owned by one thread), are added over the
// slices in a fixed order and written as the block's partial [K, 32]. A
// second launch sums the partials in index order (partials.cuh). No float
// atomics: two runs give the same bits.
//
// Windows are circular: V[m] lives in slot m % R, and the loops over taps
// (K4) and frames (K5) are unrolled by R, so the slots are registers and
// nothing moves. K4's R is DW_FWD_R, fixed when the library is built
// (tools/dw_sweep.py builds other values to sweep it); K5's R is the
// wrapper's choice from the tap groups, one of 4, 8 or 16. The wrapper
// plans the rest of the tiling (tile lengths, plane rows, warps, shared
// memory) and passes it in.
//
// Every launch uses programmatic dependent launch (common.cuh): a kernel's
// blocks may be scheduled while the previous kernel on the stream drains,
// and wait (griddepcontrol.wait) before their first global access. At
// these sizes the gap between two launches is a large share of a kernel's
// time.

#include <cuda_runtime.h>

#include "common.cuh"
#include "partials.cuh"

#ifndef DW_FWD_R
#define DW_FWD_R 16  // K4 outputs a thread
#endif

namespace {

constexpr int CT = 32;           // channels per block, two a lane
constexpr int MAX_WARPS = 16;    // a block has 1-16 warps (the plan's)
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int FWD_R = DW_FWD_R;

__device__ __forceinline__ int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Stage `rows` rows of each of the s phase planes [s][L][CT]: plane r row i
// = x row u0 + i*s + r of this batch row, zero outside [0, T) and past C.
template <typename E, bool VEC>
__device__ __forceinline__ void stage_planes(E* planes,
                                             const E* __restrict__ xb,
                                             int u0, int rows, int L, int s,
                                             int T, int C, int c0) {
  constexpr int STRIDE = copy_elems<E, VEC>();
  constexpr int PER_ROW = CT / STRIDE;
  for (int r = 0; r < s; ++r) {
    for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
      const int cq = (i % PER_ROW) * STRIDE;
      const int row = i / PER_ROW;
      const int t = u0 + row * s + r;
      const bool ok = t >= 0 && t < T && c0 + cq < C;
      const E* src = ok ? xb + (size_t)t * C + c0 + cq : xb;
      copy_to_shared<E, VEC>(planes + ((size_t)r * L + row) * CT + cq, src,
                             ok);
    }
  }
}

// Stage rows t0 .. t0 + rows - 1 of a [n_rows, C] array into [rows][CT],
// zero past n_rows and past C.
template <typename E, bool VEC>
__device__ __forceinline__ void stage_rows(E* dst, const E* __restrict__ src0,
                                           int t0, int rows, int n_rows,
                                           int C, int c0) {
  constexpr int STRIDE = copy_elems<E, VEC>();
  constexpr int PER_ROW = CT / STRIDE;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int cq = (i % PER_ROW) * STRIDE;
    const int r = i / PER_ROW;
    const bool ok = t0 + r < n_rows && c0 + cq < C;
    const E* src = ok ? src0 + (size_t)(t0 + r) * C + c0 + cq : src0;
    copy_to_shared<E, VEC>(dst + r * CT + cq, src, ok);
  }
}

__device__ __forceinline__ void fma2(float2& acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
}

// K4. Grid (tiles, C / CT, B); the plan gives the tile length TT (a
// multiple of R d', R = FWD_R) and the plane rows L = TT + ((K-1) d) div
// s. Lane l owns channels c0 + 2 (l % 16) and the next; half-warp
// h = l / 16 of warp w computes the items 2w + h, 2w + h + 2 warps, ...;
// item it: R outputs at frames f0 + i d', f0 = (it / d') R d' + it % d'.
template <typename E, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
dw_fwd_kernel(const E* __restrict__ x, const E* __restrict__ w,
              E* __restrict__ y, int T, int C, int K, int s, int d, int p,
              int T_out, int TT, int L) {
  constexpr int R = FWD_R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* planes = reinterpret_cast<E*>(smem_raw);  // [s][L][CT]
  E* w_s = planes + (size_t)s * L * CT;        // [K][CT]
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int slot = 2 * (threadIdx.x >> 5) + half;
  const int slots = blockDim.x >> 4;
  const int t0 = blockIdx.x * TT;
  const int c0 = blockIdx.y * CT;
  const int c = c0 + 2 * hl;
  const int b = blockIdx.z;
  wait_prior_grid();
  stage_planes<E, VEC>(planes, x + (size_t)b * T * C, t0 * s - p, L, L, s, T,
                       C, c0);
  stage_rows<E, VEC>(w_s, w, 0, K, K, C, c0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (c >= C) return;

  const int g = gcd_int(s, d);
  const int sp = s / g, dp = d / g;
  const int n_t = min(TT, T_out - t0);
  const int items = TT / R;  // TT / (R d') groups of d' items
  const int xstep = dp * CT;  // in elements
  const int wstep = sp * CT;
  E* yb = y + ((size_t)b * T_out + t0) * C + c;
  for (int it = slot; it < items; it += slots) {
    const int f0 = (it / dp) * R * dp + it % dp;
    if (f0 >= n_t) continue;
    float2 acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = make_float2(0.f, 0.f);
    for (int kr = 0; kr < sp && kr < K; ++kr) {
      const int n = (K - kr + sp - 1) / sp;  // taps kr, kr + s', ...
      const E* xr =
          planes + ((size_t)((kr * d) % s) * L + f0 + (kr * d) / s) * CT +
          2 * hl;
      const E* wr = w_s + kr * CT + 2 * hl;
      float2 win[R];  // V[m] in slot m % R
#pragma unroll
      for (int i = 0; i + 1 < R; ++i) win[i] = load2(xr + i * xstep);
      xr += (R - 1) * xstep;
      // Tap j + jj reads V[j + jj .. j + jj + R - 1]: whole runs of R taps
      // unguarded (so their loads can issue ahead), then the rest.
      int j = 0;
      for (; j + R <= n; j += R) {
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          win[(jj + R - 1) % R] = load2(xr + jj * xstep);
          const float2 wk = load2(wr + jj * wstep);
#pragma unroll
          for (int i = 0; i < R; ++i) fma2(acc[i], win[(jj + i) % R], wk);
        }
        xr += R * xstep;
        wr += R * wstep;
      }
#pragma unroll
      for (int jj = 0; jj + 1 < R; ++jj) {
        if (j + jj < n) {
          win[(jj + R - 1) % R] = load2(xr + jj * xstep);
          const float2 wk = load2(wr + jj * wstep);
#pragma unroll
          for (int i = 0; i < R; ++i) fma2(acc[i], win[(jj + i) % R], wk);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int f = f0 + i * dp;
      if (f < n_t) {
        store(yb + (size_t)f * C, acc[i].x);
        if (c + 1 < C) store(yb + (size_t)f * C + 1, acc[i].y);
      }
    }
  }
  allow_next_grid();
}

// K5's partials. Grid (C / CT, chunks, B); block (cx, ch, b) sums frames
// ch*TC .. of row b into part[b * chunks + ch] [K, C]. The plan gives TC,
// the staged rows a plane (TC + ((K-1) d) div s), the plane rows L (room
// for the last group's taps past its class too: their sums are dropped)
// and the time slices `slices`. Item (group, slice, u) covers frames
// slice*ceil(TC/slices) + u + m d'. Lanes and half-warps as in K4.
template <typename E, int R, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
dw_wgrad_kernel(const E* __restrict__ x, const E* __restrict__ g,
                float* __restrict__ part, int T, int C, int K, int s, int d,
                int p, int T_out, int TC, int staged, int L, int slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* planes = reinterpret_cast<E*>(smem_raw);  // [s][L][CT]
  E* g_s = planes + (size_t)s * L * CT;        // [TC][CT]
  float* acc_s =                               // [slices * d'][K][CT]
      reinterpret_cast<float*>(g_s + (size_t)TC * CT);
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int slot = 2 * (threadIdx.x >> 5) + half;
  const int slots = blockDim.x >> 4;
  const int c0 = blockIdx.x * CT;
  const int t0 = blockIdx.y * TC;
  const int b = blockIdx.z;
  const int n_t = min(TC, T_out - t0);
  const int gg = gcd_int(s, d);
  const int sp = s / gg, dp = d / gg;
  const int subs = slices * dp;
  for (int i = threadIdx.x; i < subs * K * CT; i += blockDim.x) acc_s[i] = 0.f;
  wait_prior_grid();
  stage_planes<E, VEC>(planes, x + (size_t)b * T * C, t0 * s - p, staged, L,
                       s, T, C, c0);
  stage_rows<E, VEC>(g_s, g + (size_t)b * T_out * C, t0, TC, T_out, C, c0);
  cp_async_commit();
  int groups = 0;
  for (int kr = 0; kr < sp && kr < K; ++kr) {
    groups += ((K - kr + sp - 1) / sp + R - 1) / R;
  }
  const int items = groups * subs;
  const int slice = (TC + slices - 1) / slices;
  const int xstep = dp * CT;  // in elements
  cp_async_wait<0>();
  __syncthreads();  // the row landed (and acc_s is zero)

  for (int item = slot; item < items; item += slots) {
    const int sub = item % subs;  // slice * d' + u
    const int u = sub % dp;
    const int ts = sub / dp;
    const int fa = ts * slice + u;
    const int fb = min((ts + 1) * slice, n_t);
    if (fa >= fb) continue;
    const int steps = (fb - fa + dp - 1) / dp;
    int grp = item / subs;
    int kr = 0, n = 0;
    for (;; ++kr) {  // group -> (class kr, its taps j0 ..)
      n = (K - kr + sp - 1) / sp;
      const int gk = (n + R - 1) / R;
      if (grp < gk) break;
      grp -= gk;
    }
    const int j0 = grp * R;
    float2 acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = make_float2(0.f, 0.f);
    // V[m] = plane row fa + (kr d) div s + (j0 + m) d': frame step m', tap
    // j0 + j reads V[m' + j].
    const E* xr =
        planes + ((size_t)((kr * d) % s) * L + fa + (kr * d) / s + j0 * dp) *
                     CT + 2 * hl;
    const E* gr = g_s + fa * CT + 2 * hl;
    float2 win[R];  // V[m] in slot m % R
#pragma unroll
    for (int i = 0; i + 1 < R; ++i) win[i] = load2(xr + i * xstep);
    xr += (R - 1) * xstep;
    // Frame step m + mm: whole runs of R steps unguarded (so their loads
    // can issue ahead), then the rest.
    int m = 0;
    for (; m + R <= steps; m += R) {
#pragma unroll
      for (int mm = 0; mm < R; ++mm) {
        win[(mm + R - 1) % R] = load2(xr + mm * xstep);
        const float2 gv = load2(gr + mm * xstep);
#pragma unroll
        for (int j = 0; j < R; ++j) fma2(acc[j], win[(mm + j) % R], gv);
      }
      xr += R * xstep;
      gr += R * xstep;
    }
#pragma unroll
    for (int mm = 0; mm + 1 < R; ++mm) {
      if (m + mm < steps) {
        win[(mm + R - 1) % R] = load2(xr + mm * xstep);
        const float2 gv = load2(gr + mm * xstep);
#pragma unroll
        for (int j = 0; j < R; ++j) fma2(acc[j], win[(mm + j) % R], gv);
      }
    }
    const int nj = min(R, n - j0);
    float2* a = reinterpret_cast<float2*>(
        acc_s + ((size_t)sub * K + kr + j0 * sp) * CT) + hl;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < nj) a[(size_t)j * sp * CT / 2] = acc[j];  // its own entry
    }
  }
  __syncthreads();
  // The block's partial: acc_s added over the slices, in order.
  float* pb = part + ((size_t)b * gridDim.y + blockIdx.y) * K * C;
  for (int i = threadIdx.x; i < K * CT; i += blockDim.x) {
    const int ln = i % CT;
    if (c0 + ln >= C) continue;
    float v = acc_s[i];
    for (int sub = 1; sub < subs; ++sub) v += acc_s[(size_t)sub * K * CT + i];
    pb[(size_t)(i / CT) * C + c0 + ln] = v;
  }
  allow_next_grid();
}

template <typename E>
int launch_fwd(const E* x, const E* w, E* y, int B, int T, int C, int K,
               int s, int d, int p, int T_out, int TT, int L, int warps,
               int vec, size_t smem, cudaStream_t st) {
  if (warps < 1 || warps > MAX_WARPS) return cudaErrorInvalidValue;
  static SmemLimit limit_vec, limit_one;
  const dim3 grid((T_out + TT - 1) / TT, (C + CT - 1) / CT, B);
  int err;
  if (vec) {
    err = limit_vec.raise_to(dw_fwd_kernel<E, true>, smem);
    if (err) return err;
    return launch_pdl(dw_fwd_kernel<E, true>, grid, 32 * warps, smem, st, x,
                      w, y, T, C, K, s, d, p, T_out, TT, L);
  }
  err = limit_one.raise_to(dw_fwd_kernel<E, false>, smem);
  if (err) return err;
  return launch_pdl(dw_fwd_kernel<E, false>, grid, 32 * warps, smem, st, x,
                    w, y, T, C, K, s, d, p, T_out, TT, L);
}

template <typename E, int R>
int launch_wgrad(const E* x, const E* g, float* part, int B, int T, int C,
                 int K, int s, int d, int p, int T_out, int TC, int staged,
                 int L, int slices, int warps, int vec, size_t smem,
                 cudaStream_t st) {
  static SmemLimit limit_vec, limit_one;
  const dim3 grid((C + CT - 1) / CT, (T_out + TC - 1) / TC, B);
  int err;
  if (vec) {
    err = limit_vec.raise_to(dw_wgrad_kernel<E, R, true>, smem);
    if (err) return err;
    return launch_pdl(dw_wgrad_kernel<E, R, true>, grid, 32 * warps, smem,
                      st, x, g, part, T, C, K, s, d, p, T_out, TC, staged, L,
                      slices);
  }
  err = limit_one.raise_to(dw_wgrad_kernel<E, R, false>, smem);
  if (err) return err;
  return launch_pdl(dw_wgrad_kernel<E, R, false>, grid, 32 * warps, smem, st,
                    x, g, part, T, C, K, s, d, p, T_out, TC, staged, L,
                    slices);
}

// K5's two launches, R of 4, 8, 16.
template <typename E>
int wgrad_entry(const E* x, const E* g, float* part, float* dw, int B, int T,
                int C, int K, int s, int d, int p, int T_out, int R, int TC,
                int staged, int L, int slices, int warps, int vec,
                long long smem, cudaStream_t st) {
  if (warps < 1 || warps > MAX_WARPS) return cudaErrorInvalidValue;
#define DW_WGRAD_CASE(RR)                                                   \
  case RR: err = launch_wgrad<E, RR>(x, g, part, B, T, C, K, s, d, p, T_out, \
                                     TC, staged, L, slices, warps, vec, smem, \
                                     st);                                   \
    break;
  int err;
  switch (R) {
    DW_WGRAD_CASE(4)
    DW_WGRAD_CASE(8)
    DW_WGRAD_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef DW_WGRAD_CASE
  if (err) return err;
  const int parts = ((T_out + TC - 1) / TC) * B;
  return launch_sum_partials(part, parts, (long long)K * C, dw, st);
}

}  // namespace

// K4 on `stream`: y [B, T_out, C] from x [B, T, C] and w [K, C], with the
// wrapper's plan (tile TT, a multiple of DW_FWD_R d'; plane rows L; warps;
// `vec` for 16-byte copies; shared bytes). Returns a cudaError_t (0 on
// success). dw_fwd_launch_bf16: the same on bfloat16 x, w and y.
extern "C" int dw_fwd_launch(const float* x, const float* w, float* y, int B,
                             int T, int C, int K, int s, int d, int p,
                             int T_out, int TT, int L, int warps, int vec,
                             long long smem, void* stream) {
  return launch_fwd(x, w, y, B, T, C, K, s, d, p, T_out, TT, L, warps, vec,
                    smem, static_cast<cudaStream_t>(stream));
}

extern "C" int dw_fwd_launch_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* w, __nv_bfloat16* y,
                                  int B, int T, int C, int K, int s, int d,
                                  int p, int T_out, int TT, int L, int warps,
                                  int vec, long long smem, void* stream) {
  return launch_fwd(x, w, y, B, T, C, K, s, d, p, T_out, TT, L, warps, vec,
                    smem, static_cast<cudaStream_t>(stream));
}

// K5 on `stream`: dw [K, C] from x [B, T, C] and g [B, T_out, C], with the
// wrapper's plan (R of 4, 8, 16; chunk TC; staged and plane rows; slices;
// warps; `vec`; shared bytes), through `part` [B * chunks, K, C]
// (scratch): two launches, the partials, then their sum in index order.
// dw_wgrad_launch_bf16: the same on bfloat16 x and g (part and dw float32).
extern "C" int dw_wgrad_launch(const float* x, const float* g, float* part,
                               float* dw, int B, int T, int C, int K, int s,
                               int d, int p, int T_out, int R, int TC,
                               int staged, int L, int slices, int warps,
                               int vec, long long smem, void* stream) {
  return wgrad_entry(x, g, part, dw, B, T, C, K, s, d, p, T_out, R, TC,
                     staged, L, slices, warps, vec, smem,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int dw_wgrad_launch_bf16(const __nv_bfloat16* x,
                                    const __nv_bfloat16* g, float* part,
                                    float* dw, int B, int T, int C, int K,
                                    int s, int d, int p, int T_out, int R,
                                    int TC, int staged, int L, int slices,
                                    int warps, int vec, long long smem,
                                    void* stream) {
  return wgrad_entry(x, g, part, dw, B, T, C, K, s, d, p, T_out, R, TC,
                     staged, L, slices, warps, vec, smem,
                     static_cast<cudaStream_t>(stream));
}
