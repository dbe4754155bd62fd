"""K4 and K5: depthwise 1-D convolution (forward, weight gradient), as CUDA
kernels and in plain PyTorch, joined by an autograd Function.

Replaces ``wav2letter_pytorch_tpu/ops/depthwise_pallas.py``:
``depthwise_fwd`` launches ``csrc/depthwise.cu``'s K4 (``_dw_pallas``) and
``depthwise_wgrad`` its K5 (``_dw_pallas_wgrad``) for CUDA tensors, and run
their plain versions (explicit K-tap loops) for CPU tensors; neither ever
falls back from one to the other. ``DepthwiseConv1d`` is the
``custom_vjp`` of ``_dw_op``: the input gradient is K4 again, at stride 1
on the zero-stuffed cotangent with the flipped kernel, the weight gradient
is K5. Layout ``[B, T, C]``, as in JAX. ``depthwise_fwd.launches`` and
``depthwise_wgrad.launches`` count calls that launched the kernel (K5 is
two launches: partial sums, then their fixed-order sum), and
``.bf16_launches`` those of them on bfloat16 x. ``fwd_plan`` and
``wgrad_plan`` cut the kernels' work into blocks, register windows and
shared memory; ``tests/test_torch_dw_tiles.py`` models that tiling in
numpy.

Elements: float32, or bfloat16 (``model.compute_dtype=bf16``), with the
TPU kernel's contract: bf16 x and w in, the taps summed in float32, y
rounded to bf16; K5 reads bf16 x and g and gives a float32 dw, which
``DepthwiseConv1d`` rounds to w's dtype as ``_dw_op_bwd`` does. The plain
versions keep the same contract (float32 math on the bf16 values, the same
roundings). A kernel never converts a bf16 tensor to float32 for itself:
what it does not take, it refuses.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build


def out_length(t: int, k: int, s: int, d: int, p: int) -> int:
    """Conv output length, floor division."""
    return (t + 2 * p - d * (k - 1) - 1) // s + 1


def _taps(x_pad: torch.Tensor, k: int, s: int, d: int, t_out: int):
    """Tap ``k``'s view of the padded input: frames t*s + k*d."""
    return x_pad[:, k * d:k * d + (t_out - 1) * s + 1:s, :]


def depthwise_fwd_reference(x: torch.Tensor, w: torch.Tensor, stride: int,
                            dilation: int, padding: int) -> torch.Tensor:
    """Plain K4: y[b, t, c] = sum_k w[k, c] * x_pad[b, t*s + k*d, c], the
    K taps added in order. x [B, T, C], w [K, C] -> [B, T_out, C]. bf16 x
    and w: the sum in float32, y rounded to bf16."""
    if x.dtype == torch.bfloat16:
        return depthwise_fwd_reference(x.float(), w.float(), stride,
                                       dilation, padding).to(x.dtype)
    B, T, C = x.shape
    K = w.shape[0]
    t_out = out_length(T, K, stride, dilation, padding)
    xp = F.pad(x, (0, 0, padding, padding))
    y = torch.zeros((B, t_out, C), dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + _taps(xp, k, stride, dilation, t_out) * w[k]
    return y


def depthwise_wgrad_reference(x: torch.Tensor, g: torch.Tensor, K: int,
                              stride: int, dilation: int,
                              padding: int) -> torch.Tensor:
    """Plain K5: dw[k, c] = sum_{b, t} x_pad[b, t*s + k*d, c] * g[b, t, c].
    x [B, T, C], g [B, T_out, C] -> [K, C], float32 (bf16 x and g summed
    in float32)."""
    if x.dtype == torch.bfloat16:
        x, g = x.float(), g.float()
    t_out = g.shape[1]
    xp = F.pad(x, (0, 0, padding, padding))
    return torch.stack([(_taps(xp, k, stride, dilation, t_out) * g)
                        .sum(dim=(0, 1)) for k in range(K)])


DTYPES = (torch.float32, torch.bfloat16)   # the kernels' element types


def _check(name: str, **tensors):
    """Every tensor on one device, of one of ``DTYPES``, all the same, and
    contiguous."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    if dtype not in DTYPES:
        raise ValueError(f'{name}: takes float32 or bfloat16, got {dtype}')
    for what, t in tensors.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f'{name}: {what} must be {dtype} on {dev}, got '
                             f'{t.dtype} on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {what} must be contiguous')


def _check_geometry(name, T, K, s, d, p):
    if K < 1 or s < 1 or d < 1 or p < 0:
        raise ValueError(f'{name}: need K, stride, dilation >= 1 and '
                         f'padding >= 0, got K={K}, s={s}, d={d}, p={p}')
    if out_length(T, K, s, d, p) < 1:
        raise ValueError(f'{name}: T={T} gives no output frame at K={K}, '
                         f's={s}, d={d}, p={p}')


# The kernels' tiling, as csrc/depthwise.cu takes it (the tiling test reads
# CT, MAX_WARPS, DW_FWD_R and the K5 R cases back from the source). A lane
# owns two channels, and each half-warp an item of work.
CT = 32                   # channels a block
MAX_WARPS = 16            # warps a block at most
# The values are tools/dw_sweep.py's picks at QuartzNet's C1 and the TPU
# check grid (PERF.md, the K4/K5 findings); the sweep sets them to other
# values for its own runs.
FWD_R = 16                # K4 outputs a thread: the library's DW_FWD_R
FWD_TILE = 128            # K4: output frames a block aims for
WGRAD_R_CHOICES = (4, 8, 16)  # K5 taps a thread, as built
WGRAD_CHUNK = 128         # K5: frames a block aims for
WGRAD_WARPS = 8           # K5: warps a block aims for (slicing its frames)
WGRAD_MIN_SLICE = 16      # K5: fewest frames of a slice


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _class_sizes(K: int, s: int, d: int) -> list:
    """Taps of each plane class kr < s' (taps kr, kr + s', ...)."""
    sp = s // math.gcd(s, d)
    return [_cdiv(K - kr, sp) for kr in range(min(sp, K))]


class FwdPlan(NamedTuple):
    """How K4 cuts its work: blocks of ``tile`` output frames (a multiple
    of r*d'), ``rows`` rows a phase plane, ``warps`` a block (each
    half-warp taking items of ``r`` outputs), ``smem`` bytes (x's planes
    and w at ``esize`` bytes an element)."""
    r: int
    tile: int
    rows: int
    warps: int
    smem: int


class WgradPlan(NamedTuple):
    """How K5 cuts its work: a block per (32 channels, chunk of ``chunk``
    frames, batch row), ``staged`` of ``rows`` rows a phase plane, groups
    of up to ``r`` taps, the chunk cut into ``slices`` in time; ``warps`` a
    block, ``partials`` summed by the second launch, ``smem`` bytes (the
    planes and g at ``esize`` bytes an element, the float32 sums)."""
    r: int
    chunk: int
    staged: int
    rows: int
    slices: int
    warps: int
    partials: int
    smem: int


def fwd_plan(T_out: int, K: int, s: int, d: int, esize: int = 4) -> FwdPlan:
    """K4's plan: about FWD_TILE frames a block, the tiles of a row as even
    as whole groups of FWD_R*d' frames allow; ``esize`` the bytes of an
    element (4 float32, 2 bfloat16)."""
    r = FWD_R
    span = r * (d // math.gcd(s, d))
    tt = _cdiv(_cdiv(T_out, _cdiv(T_out, FWD_TILE)), span) * span
    rows = tt + (K - 1) * d // s
    warps = min(_cdiv(tt // r, 2), MAX_WARPS)
    return FwdPlan(r, tt, rows, warps, esize * CT * (s * rows + K))


def wgrad_plan(B: int, T_out: int, K: int, s: int, d: int,
               esize: int = 4) -> WgradPlan:
    """K5's plan: about WGRAD_CHUNK frames a block (as even as the chunks
    of a row allow); the smallest R whose tap groups fit the block; the
    frames sliced until a block has about WGRAD_WARPS warps."""
    dp = d // math.gcd(s, d)
    sizes = _class_sizes(K, s, d)

    def n_groups(r_):
        return sum(_cdiv(n, r_) for n in sizes)
    r = next((c for c in WGRAD_R_CHOICES
              if n_groups(c) * dp <= 2 * MAX_WARPS), WGRAD_R_CHOICES[-1])
    chunks = _cdiv(T_out, WGRAD_CHUNK)
    tc = _cdiv(T_out, chunks)
    per_sub = n_groups(r) * dp
    slices = max(1, min(_cdiv(2 * WGRAD_WARPS, per_sub),
                        2 * MAX_WARPS // per_sub, tc // WGRAD_MIN_SLICE))
    staged = tc + (K - 1) * d // s
    rows = staged + (r - 1) * dp
    warps = min(_cdiv(per_sub * slices, 2), MAX_WARPS)
    smem = esize * CT * (s * rows + tc) + 4 * CT * slices * dp * K
    return WgradPlan(r, tc, staged, rows, slices, warps, chunks * B, smem)


def _check_smem(smem: int, K: int, s: int, d: int):
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(f'depthwise: K={K}, stride {s}, dilation {d} need '
                         f'{smem} bytes of shared memory, over the limit of '
                         f'{_build.SMEM_LIMIT_BYTES}')


def _vec(C: int, *tensors) -> int:
    """1 where 16-byte copies are safe: C a multiple of 16 bytes' elements
    (4 float32, 8 bfloat16) and aligned bases."""
    per = 16 // tensors[0].element_size()
    return int(C % per == 0 and all(t.data_ptr() % 16 == 0
                                    for t in tensors))


def _launch_fwd(x, w, s, d, p):
    _check('depthwise_fwd', x=x, w=w)
    B, T, C = x.shape
    K = w.shape[0]
    if w.dim() != 2 or w.shape[1] != C:
        raise ValueError(f'depthwise_fwd: w must be [K, {C}], got '
                         f'{tuple(w.shape)}')
    _check_geometry('depthwise_fwd', T, K, s, d, p)
    t_out = out_length(T, K, s, d, p)
    plan = fwd_plan(t_out, K, s, d, x.element_size())
    _check_smem(plan.smem, K, s, d)
    lib = _build.load('depthwise')
    y = torch.empty((B, t_out, C), dtype=x.dtype, device=x.device)
    fn = (lib.dw_fwd_launch if x.dtype == torch.float32
          else lib.dw_fwd_launch_bf16)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [
        ctypes.c_longlong, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, C, K, s, d,
                  p, t_out, plan.tile, plan.rows, plan.warps, _vec(C, x, w),
                  plan.smem, stream)
    _build.check(lib, code, 'depthwise K4 launch')
    depthwise_fwd.launches += 1
    depthwise_fwd.bf16_launches += x.dtype == torch.bfloat16
    return y


def depthwise_fwd(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """K4: depthwise conv of x [B, T, C] with w [K, C] at ``stride``,
    ``dilation`` and symmetric zero ``padding`` -> [B, T_out, C] in x's
    dtype. A CUDA tensor goes through the kernel (float32 or bfloat16,
    both alike, contiguous; raises on anything else or on a failed
    launch), a CPU tensor through the plain version. No gradient: see
    ``depthwise_conv1d``."""
    if x.device.type == 'cuda':
        return _launch_fwd(x.detach(), w.detach(), int(stride),
                           int(dilation), int(padding))
    if x.device.type != 'cpu':
        raise ValueError(f'depthwise_fwd: unsupported device {x.device}')
    with torch.no_grad():
        return depthwise_fwd_reference(x, w, stride, dilation, padding)


depthwise_fwd.launches = 0
depthwise_fwd.bf16_launches = 0   # of them, on bfloat16 x


def _launch_wgrad(x, g, K, s, d, p):
    _check('depthwise_wgrad', x=x, g=g)
    B, T, C = x.shape
    _check_geometry('depthwise_wgrad', T, K, s, d, p)
    t_out = out_length(T, K, s, d, p)
    if tuple(g.shape) != (B, t_out, C):
        raise ValueError(f'depthwise_wgrad: g must be {(B, t_out, C)}, got '
                         f'{tuple(g.shape)}')
    plan = wgrad_plan(B, t_out, K, s, d, x.element_size())
    _check_smem(plan.smem, K, s, d)
    lib = _build.load('depthwise')
    part = torch.empty((plan.partials, K, C), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((K, C), dtype=torch.float32, device=x.device)
    fn = (lib.dw_wgrad_launch if x.dtype == torch.float32
          else lib.dw_wgrad_launch_bf16)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [
        ctypes.c_longlong, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                  B, T, C, K, s, d, p, t_out, plan.r, plan.chunk, plan.staged,
                  plan.rows, plan.slices, plan.warps, _vec(C, x, g),
                  plan.smem, stream)
    _build.check(lib, code, 'depthwise K5 launch')
    depthwise_wgrad.launches += 1
    depthwise_wgrad.bf16_launches += x.dtype == torch.bfloat16
    return dw


def depthwise_wgrad(x: torch.Tensor, g: torch.Tensor, K: int, stride: int = 1,
                    dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """K5: the weight gradient [K, C], float32, of ``depthwise_fwd`` from
    its input x [B, T, C] and the cotangent g [B, T_out, C] (both float32
    or both bfloat16). CUDA: the kernel; CPU: the plain version."""
    if x.device.type == 'cuda':
        return _launch_wgrad(x.detach(), g.detach(), int(K), int(stride),
                             int(dilation), int(padding))
    if x.device.type != 'cpu':
        raise ValueError(f'depthwise_wgrad: unsupported device {x.device}')
    with torch.no_grad():
        return depthwise_wgrad_reference(x, g, K, stride, dilation, padding)


depthwise_wgrad.launches = 0
depthwise_wgrad.bf16_launches = 0   # of them, on bfloat16 x


def dgrad_args(g: torch.Tensor, w: torch.Tensor, T: int, stride: int,
               dilation: int, padding: int):
    """The stride-1 K4 call of the input gradient, as ``_dw_op_bwd`` forms
    it: (g stuffed with stride - 1 zeros between frames and ``rem`` extra
    right zeros, the flipped w, padding d(K-1) - p; where that padding is
    negative, g is trimmed instead)."""
    B, t_out, C = g.shape
    K = w.shape[0]
    if stride > 1:
        rem = (T + 2 * padding - dilation * (K - 1) - 1) % stride
        g_in = g.new_zeros((B, (t_out - 1) * stride + 1 + rem, C))
        g_in[:, :(t_out - 1) * stride + 1:stride] = g
    else:
        g_in = g
    pad_t = dilation * (K - 1) - padding
    if pad_t < 0:
        g_in = g_in[:, -pad_t:g_in.shape[1] + pad_t, :]
        pad_t = 0
    return g_in.contiguous(), w.flip(0).contiguous(), pad_t


def depthwise_dgrad(g: torch.Tensor, w: torch.Tensor, T: int, stride: int,
                    dilation: int, padding: int) -> torch.Tensor:
    """The input gradient [B, T, C] from the cotangent g [B, T_out, C]: K4
    on ``dgrad_args``, trimmed (or zero-padded) to T frames."""
    g_in, w_flip, pad_t = dgrad_args(g, w, T, stride, dilation, padding)
    dx = depthwise_fwd(g_in, w_flip, 1, dilation, pad_t)
    if dx.shape[1] < T:
        dx = F.pad(dx, (0, 0, 0, T - dx.shape[1]))
    return dx[:, :T]


class DepthwiseConv1d(torch.autograd.Function):
    """Depthwise conv with a gradient in x and w: forward K4; backward K4
    (input gradient, ``depthwise_dgrad``, in g's dtype) and K5 (weight
    gradient, rounded to w's dtype: bf16 for a bf16 w, as JAX's)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, dilation: int, padding: int):
        ctx.geometry = (int(stride), int(dilation), int(padding))
        ctx.save_for_backward(x, w)
        return depthwise_fwd(x, w, stride, dilation, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, d, p = ctx.geometry
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_dgrad(g, w.detach(), x.shape[1], s, d, p)
        if ctx.needs_input_grad[1]:
            dw = depthwise_wgrad(x.detach(), g, w.shape[0], s, d,
                                 p).to(w.dtype)
        return dx, dw, None, None, None


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """Depthwise 1-D conv, differentiable: x [B, T, C], w [K, C] ->
    [B, T_out, C]. The counterpart of the JAX package's
    ``depthwise_conv1d``."""
    return DepthwiseConv1d.apply(x, w, stride, dilation, padding)
