"""K6 and K7: the fused masked separable-conv unit (mask -> depthwise ->
mask -> pointwise), forward and backward, as CUDA kernels and in plain
PyTorch, joined by an autograd Function.

Replaces ``wav2letter_pytorch_tpu/ops/sep_conv_pallas.py``: ``sep_fwd``
launches ``csrc/sep_conv.cu``'s K6 (``_sep_fwd``) and ``sep_bwd`` its K7
(``_sep_op_bwd``) for CUDA tensors, and run their plain versions for CPU
tensors; neither ever falls back from one to the other. ``SepConv1d`` is
the ``custom_vjp`` of ``_sep_op``; ``lens`` only shapes the masks and gets
no gradient. Stride is 1. ``sep_fwd.launches`` and ``sep_bwd.launches``
count calls that launched the kernel (a K7 call is five launches of the
one source: the g @ wpw^T product, the depthwise pass, the dwpw product
and two fixed-order sums of partials), ``.bf16_launches`` those on
bfloat16 x. ``bwd_plan`` cuts K7's work into
blocks and partials; ``tests/test_torch_sep_bwd_tiles.py`` models that
tiling in numpy.

x is float32 or bfloat16 (``model.compute_dtype=bf16``), as the TPU
kernels take it: K6 reads bf16 x into float32 and keeps the weights, the
depthwise intermediate, the product and y float32; K7 gives dx in x's
dtype (rounded to nearest even) and dwdw, dwpw float32. The weights and g
are float32. The plain versions keep the same contract; a kernel never
converts a bf16 tensor to float32 for itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build


# K7's tiles, as csrc/sep_conv.cu sets them (the tiling test reads them
# back from the source).
DW_TT = 64        # (ii) frames of a time tile
DW_CG = 32        # (ii) input channels of a block, one a lane
# The block targets are the fastest pair of tools/k7_split.py --sweep at
# QuartzNet's shapes; at 256, (ii) cuts rows into time groups only when
# B * Cin/32 is below it, else a block walks every tile of its row.
DW_TARGET_BLOCKS = 256    # (ii) blocks a call aims for
PW_BM = PW_BN = 128       # (iii) output tile of the dwpw product
PW_BK = 16                # (iii) rows of the B*T_out reduction a stage
PW_TARGET_BLOCKS = 264    # (iii) one wave: 2 blocks on each of 132 SMs
PW_MIN_ROWS = 64          # (iii) fewest rows a partial sums


class BwdPlan(NamedTuple):
    """How K7 cuts its work. (ii): a block walks ``tiles_per_block``
    consecutive time tiles of one batch row and channel group, and
    ``time_groups`` blocks cover a row; dwdw has B * time_groups partials.
    (iii): the B*T_out rows of dwpw's reduction go in ``pw_splits`` runs of
    ``pw_rows`` (the last may be shorter), one partial each."""
    tiles_per_block: int
    time_groups: int
    pw_splits: int
    pw_rows: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(B: int, T: int, t_out: int, cin: int, cout: int) -> BwdPlan:
    """K7's blocks and partials for x [B, T, cin], g [B, t_out, cout]."""
    n_tiles = _cdiv(max(T, t_out), DW_TT)
    groups = min(n_tiles, max(1, _cdiv(DW_TARGET_BLOCKS,
                                       _cdiv(cin, DW_CG) * B)))
    per_block = _cdiv(n_tiles, groups)
    rows = B * t_out
    tiles = _cdiv(cin, PW_BM) * _cdiv(cout, PW_BN)
    splits = max(1, min(PW_TARGET_BLOCKS // tiles, _cdiv(rows, PW_MIN_ROWS)))
    pw_rows = _cdiv(_cdiv(rows, splits), PW_BK) * PW_BK
    return BwdPlan(per_block, _cdiv(n_tiles, per_block),
                   _cdiv(rows, pw_rows), pw_rows)


def out_length(t: int, k: int, d: int, p: int) -> int:
    """Output frames of the unit (stride 1)."""
    return t + 2 * p - d * (k - 1)


def mask_lengths(lens: torch.Tensor, K: int, d: int, p: int):
    """(len1, len2) int32 [B]: the frames kept by m1 on the input and by m2
    on the depthwise output, cast from float lengths as ``_masks`` does:
    int(lens) and int(lens + 2p - d(K-1) - 1 + 1)."""
    lf = lens.to(torch.float32)
    lens_dw = (lf + 2 * p - d * (K - 1) - 1) + 1
    return (lf.to(torch.int32).contiguous(),
            lens_dw.to(torch.int32).contiguous())


def _masks(len1, len2, T: int, t_out: int, dtype, device):
    m1 = (torch.arange(T, device=device)[None, :] < len1[:, None].long())
    m2 = (torch.arange(t_out, device=device)[None, :]
          < len2[:, None].long())
    return m1[..., None].to(dtype), m2[..., None].to(dtype)


def _depthwise(xm, wdw, d, p, t_out):
    """K-tap loop, stride 1: sum_k wdw[k] * xm_pad[t + k*d]."""
    xp = F.pad(xm, (0, 0, p, p))
    h = torch.zeros(xm.shape[0], t_out, xm.shape[2], dtype=xm.dtype,
                    device=xm.device)
    for k in range(wdw.shape[0]):
        h = h + xp[:, k * d:k * d + t_out] * wdw[k]
    return h


def sep_fwd_reference(x, len1, len2, wdw, wpw, dilation: int,
                      padding: int) -> torch.Tensor:
    """Plain K6, mirroring ``sep_conv1d_xla``: x * m1 -> K-tap depthwise
    loop -> * m2 -> einsum with wpw. ``len1``/``len2`` int [B] or None (no
    masks). A bf16 x is read into float32 (y float32)."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    B, T, _ = x.shape
    K = wdw.shape[0]
    t_out = out_length(T, K, dilation, padding)
    if len1 is not None:
        m1, m2 = _masks(len1, len2, T, t_out, x.dtype, x.device)
        x = x * m1
    h = _depthwise(x, wdw, dilation, padding, t_out)
    if len1 is not None:
        h = h * m2
    return torch.einsum('btc,cf->btf', h, wpw)


def sep_bwd_reference(x, len1, len2, wdw, wpw, g, dilation: int,
                      padding: int):
    """Plain K7, the TPU kernel's arithmetic: recompute the depthwise
    output, then dwpw = (dwres * m2)^T g, g_dw = (g wpw^T) * m2, dwdw[k] =
    sum_t x_pad[t + kd] g_dw[t], dx = m1 * (the flipped-kernel conv of
    g_dw at padding d(K-1) - p). Returns (dx, dwdw, dwpw): dx in x's dtype
    (a bf16 x read into float32, dx rounded at the end), the rest
    float32."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x = x.float()
    B, T, C = x.shape
    K = wdw.shape[0]
    d, p = dilation, padding
    t_out = g.shape[1]
    if len1 is not None:
        m1, m2 = _masks(len1, len2, T, t_out, x.dtype, x.device)
        x = x * m1
    dwres = _depthwise(x, wdw, d, p, t_out)
    if len1 is not None:
        dwres = dwres * m2
    dwpw = torch.einsum('btc,btf->cf', dwres, g)
    g_dw = torch.einsum('btf,cf->btc', g, wpw)
    if len1 is not None:
        g_dw = g_dw * m2
    xp = F.pad(x, (0, 0, p, p))
    dwdw = torch.stack([(xp[:, k * d:k * d + t_out] * g_dw).sum(dim=(0, 1))
                        for k in range(K)])
    pt = d * (K - 1) - p
    gp = F.pad(g_dw, (0, 0, pt, pt))   # a negative pt trims
    dx = torch.zeros_like(x)
    for k in range(K):
        dx = dx + gp[:, k * d:k * d + T] * wdw[K - 1 - k]
    if len1 is not None:
        dx = dx * m1
    return dx.to(dtype), dwdw, dwpw


def _check(name: str, **tensors):
    """x float32 or bfloat16; the lengths int32; the rest float32; all on
    x's device and contiguous."""
    dev = next(iter(tensors.values())).device
    for what, t in tensors.items():
        if t is None:
            continue
        want = (torch.int32 if what.startswith('len') else
                t.dtype if what == 'x' and t.dtype == torch.bfloat16
                else torch.float32)
        if t.device != dev or t.dtype != want:
            raise ValueError(f'{name}: {what} must be {want} on {dev}, got '
                             f'{t.dtype} on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {what} must be contiguous')


def _geometry(name, x, len1, len2, wdw, wpw, d, p):
    B, T, C = x.shape
    K = wdw.shape[0]
    if tuple(wdw.shape) != (K, C) or wpw.dim() != 2 or wpw.shape[0] != C:
        raise ValueError(f'{name}: wdw must be [K, {C}] and wpw [{C}, Cout], '
                         f'got {tuple(wdw.shape)} and {tuple(wpw.shape)}')
    if (len1 is None) != (len2 is None) or (
            len1 is not None and (tuple(len1.shape) != (B,)
                                  or tuple(len2.shape) != (B,))):
        raise ValueError(f'{name}: len1 and len2 must both be [{B}] or both '
                         'None')
    if K < 1 or d < 1 or not 0 <= p <= d * (K - 1):
        raise ValueError(f'{name}: the kernel takes K >= 1, dilation >= 1 '
                         f'and 0 <= padding <= d(K-1) (stride 1 only), got '
                         f'K={K}, d={d}, p={p}')
    t_out = out_length(T, K, d, p)
    if t_out < 1:
        raise ValueError(f'{name}: T={T} gives no output frame')
    return B, T, C, K, wpw.shape[1], t_out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its functions' ctypes signatures set once."""
    lib = _build.load('sep_conv')
    lib.sep_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.sep_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sep_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.sep_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    for suffix in ('', '_bf16'):
        fwd = getattr(lib, 'sep_fwd_launch' + suffix)
        fwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        bwd = getattr(lib, 'sep_bwd_launch' + suffix)
        bwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
    return lib


def _launcher(lib: ctypes.CDLL, name: str, x: torch.Tensor):
    """``lib``'s float32 entry point ``name``, or its bfloat16 twin for a
    bf16 x."""
    return getattr(lib, name if x.dtype == torch.float32 else name + '_bf16')


def _check_smem(smem: int, K: int, d: int) -> None:
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(f'sep_conv: K={K}, dilation {d} need {smem} bytes '
                         f'of shared memory, over the limit of '
                         f'{_build.SMEM_LIMIT_BYTES}')


@functools.cache
def _fwd_smem(K: int, d: int, cout: int, esize: int) -> int:
    smem = _library().sep_fwd_smem_bytes(K, d, cout, esize)
    _check_smem(smem, K, d)
    return smem


@functools.cache
def _bwd_smem(K: int, d: int, esize: int) -> int:
    smem = _library().sep_bwd_smem_bytes(K, d, esize)
    _check_smem(smem, K, d)
    return smem


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, len1, len2, wdw, wpw, d, p):
    _check('sep_fwd', x=x, wdw=wdw, wpw=wpw, len1=len1, len2=len2)
    B, T, C, K, cout, t_out = _geometry('sep_fwd', x, len1, len2, wdw, wpw,
                                        d, p)
    lib = _library()
    _fwd_smem(K, d, cout, x.element_size())
    y = torch.empty((B, t_out, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _launcher(lib, 'sep_fwd_launch', x)(
            x.data_ptr(), _ptr(len1), _ptr(len2), wdw.data_ptr(),
            wpw.data_ptr(), y.data_ptr(), B, T, C, cout, K, d, p, t_out,
            stream)
    _build.check(lib, code, 'sep_conv K6 launch')
    sep_fwd.launches += 1
    sep_fwd.bf16_launches += x.dtype == torch.bfloat16
    return y


def sep_fwd(x: torch.Tensor, len1, len2, wdw: torch.Tensor,
            wpw: torch.Tensor, dilation: int = 1,
            padding: int = 0) -> torch.Tensor:
    """K6: y [B, T_out, Cout] of the unit; ``len1``/``len2`` from
    ``mask_lengths`` or both None (no masks). CUDA: the kernel (x float32
    or bfloat16, the weights float32, the lengths int32, contiguous; raises
    on anything else or a failed launch); CPU: the plain version. No
    gradient: see ``sep_conv1d``."""
    if x.device.type == 'cuda':
        return _launch_fwd(x.detach(), len1, len2, wdw.detach(),
                           wpw.detach(), int(dilation), int(padding))
    if x.device.type != 'cpu':
        raise ValueError(f'sep_fwd: unsupported device {x.device}')
    with torch.no_grad():
        return sep_fwd_reference(x, len1, len2, wdw, wpw, dilation, padding)


sep_fwd.launches = 0
sep_fwd.bf16_launches = 0   # of them, on bfloat16 x


def _launch_bwd(x, len1, len2, wdw, wpw, g, d, p):
    _check('sep_bwd', x=x, wdw=wdw, wpw=wpw, g=g, len1=len1, len2=len2)
    B, T, C, K, cout, t_out = _geometry('sep_bwd', x, len1, len2, wdw, wpw,
                                        d, p)
    if tuple(g.shape) != (B, t_out, cout):
        raise ValueError(f'sep_bwd: g must be {(B, t_out, cout)}, got '
                         f'{tuple(g.shape)}')
    lib = _library()
    _bwd_smem(K, d, x.element_size())
    plan = bwd_plan(B, T, t_out, C, cout)
    dev = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, C), dtype=x.dtype, device=dev)
    dwdw, dwpw = empty(K, C), empty(C, cout)
    gdw, dwres = empty(B, t_out, C), empty(B, t_out, C)
    part_dw = empty(B * plan.time_groups, K, C)
    part_pw = empty(plan.pw_splits, C, cout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _launcher(lib, 'sep_bwd_launch', x)(
            x.data_ptr(), _ptr(len1), _ptr(len2), wdw.data_ptr(),
            wpw.data_ptr(), g.data_ptr(), dx.data_ptr(), dwdw.data_ptr(),
            dwpw.data_ptr(), gdw.data_ptr(), dwres.data_ptr(),
            part_dw.data_ptr(), part_pw.data_ptr(), B, T, C, cout, K, d, p,
            t_out, *plan, stream)
    _build.check(lib, code, 'sep_conv K7 launch')
    sep_bwd.launches += 1
    sep_bwd.bf16_launches += x.dtype == torch.bfloat16
    return dx, dwdw, dwpw


def sep_bwd(x: torch.Tensor, len1, len2, wdw: torch.Tensor,
            wpw: torch.Tensor, g: torch.Tensor, dilation: int = 1,
            padding: int = 0):
    """K7: (dx, dwdw, dwpw) of the unit from the cotangent g [B, T_out,
    Cout] (float32): dx in x's dtype, the weight gradients float32. CUDA:
    the kernel; CPU: the plain version."""
    if x.device.type == 'cuda':
        return _launch_bwd(x.detach(), len1, len2, wdw.detach(),
                           wpw.detach(), g.detach(), int(dilation),
                           int(padding))
    if x.device.type != 'cpu':
        raise ValueError(f'sep_bwd: unsupported device {x.device}')
    with torch.no_grad():
        return sep_bwd_reference(x, len1, len2, wdw, wpw, g, dilation,
                                 padding)


sep_bwd.launches = 0
sep_bwd.bf16_launches = 0   # of them, on bfloat16 x


class SepConv1d(torch.autograd.Function):
    """The fused unit with a gradient in x, wdw and wpw: forward K6,
    backward K7."""

    @staticmethod
    def forward(ctx, x, len1, len2, wdw, wpw, dilation: int, padding: int):
        ctx.geometry = (int(dilation), int(padding))
        ctx.save_for_backward(x, len1, len2, wdw, wpw)
        return sep_fwd(x, len1, len2, wdw, wpw, dilation, padding)

    @staticmethod
    def backward(ctx, g):
        x, len1, len2, wdw, wpw = ctx.saved_tensors
        d, p = ctx.geometry
        dx, dwdw, dwpw = sep_bwd(x, len1, len2, wdw, wpw, g.contiguous(), d,
                                 p)
        return dx, None, None, dwdw, dwpw, None, None


def shifted_lengths(len1, len2, in_lo: int, t_in: int, out_lo: int,
                    t_out: int) -> tuple:
    """``mask_lengths``' global (len1, len2) for a unit run on a range of
    the sequence (sequence parallelism): the input holds global frames
    from ``in_lo`` (negative in the left padding), ``t_in`` of them, the
    output from ``out_lo``, ``t_out``; each length becomes the count of
    the range's frames below it, in [0, frames]."""
    return (torch.clamp(len1 - in_lo, 0, t_in).to(torch.int32).contiguous(),
            torch.clamp(len2 - out_lo, 0, t_out).to(torch.int32).contiguous())


def sep_conv1d(x: torch.Tensor, lens, wdw: torch.Tensor, wpw: torch.Tensor,
               dilation: int = 1, padding: int = 0,
               use_mask: bool = True, shift=None) -> torch.Tensor:
    """Fused masked separable conv unit, differentiable in x, wdw and wpw:
    x [B, T, Cin] (float32 or bfloat16), float ``lens`` [B] (or None), wdw
    [K, Cin], wpw [Cin, Cout] (float32) -> y [B, T_out, Cout] f32, T_out =
    T + 2p - d(K-1). The counterpart of the JAX package's ``sep_conv1d``.

    ``shift=(in_lo, out_lo)``: ``x`` is already padded, the global input
    frames from ``in_lo`` that a range of the output starting at global
    frame ``out_lo`` reads (sequence parallelism); the kernel then runs
    with padding 0, T_out = T - d(K-1), and the masks' lengths
    (``padding`` the unit's own) are shifted to the two ranges."""
    K = wdw.shape[0]
    if use_mask and lens is not None:
        len1, len2 = mask_lengths(lens, K, dilation, padding)
    else:
        len1 = len2 = None
    if shift is not None:
        padding = 0
        if len1 is not None:
            t_in = x.shape[1]
            len1, len2 = shifted_lengths(
                len1, len2, int(shift[0]), t_in, int(shift[1]),
                out_length(t_in, K, dilation, 0))
    return SepConv1d.apply(x, len1, len2, wdw, wpw, int(dilation),
                           int(padding))
