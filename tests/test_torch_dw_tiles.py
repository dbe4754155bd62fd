"""A float64 numpy model of K4 and K5's tiling (``csrc/depthwise.cu``),
held against the plain versions (``ops/depthwise.py``) and the JAX
``depthwise_conv1d_xla(..., precision='highest')``.

The model walks the work as the kernels do, from the wrapper's plans
(``fwd_plan``, ``wgrad_plan``): a block's span of x staged as s stride-1
phase planes (zero outside [0, T)); K4's items of R outputs at frames
f0 + i d', the taps class by class through a circular register window that
takes one new plane row a tap; K5's blocks of one chunk of one batch row,
its items (a group of up to R taps of one class, a time slice, a residue u
of the frames mod d') through a window that takes one new row a frame, the
sums stored into owned slots and added over the slices in order, and the
blocks' partials in index order. Plane rows a K5 block does not stage
hold NaN, so a real tap that read one would show. The plan's constants are read from
the CUDA source, so the model and the kernels cannot drift apart. An index
fault in the tiling shows here, on the CPU, before the card.
"""

import functools
import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from wav2letter_pytorch_tpu.ops.depthwise_pallas import depthwise_conv1d_xla
from wav2letter_pytorch_tpu_torch import _build
from wav2letter_pytorch_tpu_torch.models.base import get_same_padding
from wav2letter_pytorch_tpu_torch.ops import depthwise
from wav2letter_pytorch_tpu_torch.ops.depthwise import (
    depthwise_dgrad, depthwise_fwd_reference, depthwise_wgrad_reference,
    fwd_plan, out_length, wgrad_plan)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(depthwise.__file__), os.pardir, 'csrc',
                   'depthwise.cu')
CT = depthwise.CT
# float64 on both sides: only the summation order differs.
RTOL = 1e-12
# The model (float64) against JAX's float32 conv at precision 'highest'.
JAX_RTOL = 1e-5
# (B, T, C, K, stride, dilation), same padding: chip_smoke's TPU grid, C1
# (the main path) and the edges of the new tiles.
SHAPES = chip_smoke.DW_GRID + [chip_smoke.DW_MAIN] + chip_smoke.DW_EDGE
# The input gradient's stride-1 geometry (K4 on the zero-stuffed, flipped
# cotangent): C1's, C2's (K = 87, d = 2), stride 2 with odd T, K = 1.
DGRAD_SHAPES = [chip_smoke.DW_MAIN, (2, 150, 40, 87, 1, 2),
                (2, 101, 50, 33, 2, 1), (3, 50, 32, 1, 1, 1)]


def _cdiv(a, b):
    return -(-a // b)


def _inputs(B, T, C, K, s, d, seed):
    rng = np.random.default_rng(seed)
    # Jasper takes stride or dilation; the kernels take both (p = d(K-1)/2)
    p = get_same_padding(K, s, d) if min(s, d) == 1 else d * (K - 1) // 2
    t_out = out_length(T, K, s, d, p)
    x = rng.standard_normal((B, T, C))
    w = 0.1 * rng.standard_normal((K, C))
    g = rng.standard_normal((B, t_out, C))
    return x, w, g, p


def _pad_c(a):
    """Channels padded with zeros to whole blocks of CT (the kernels' zero
    fill past C)."""
    out = np.zeros(a.shape[:-1] + (_cdiv(a.shape[-1], CT) * CT,))
    out[..., :a.shape[-1]] = a
    return out


def _stage(xp, t0, s, p, rows, L, fill):
    """Phase planes [B, s, L, C] of a block: plane r row i = x row
    t0*s - p + i*s + r (zero outside [0, T)) for i < rows; ``fill``
    after."""
    B, T, C = xp.shape
    planes = np.full((B, s, L, C), fill)
    for q in range(s * rows):
        t = t0 * s - p + q
        planes[:, q % s, q // s] = xp[:, t] if 0 <= t < T else 0.0
    return planes


def _row(planes, r, row, L):
    assert 0 <= row < L, (row, L)
    return planes[:, r, row]


def model_k4(x, w, s, d, p, plan):
    """y as K4 computes it, block by block (all batch rows and channel
    blocks of one tile at once)."""
    B, T, C = x.shape
    K = w.shape[0]
    t_out = out_length(T, K, s, d, p)
    g_ = math.gcd(s, d)
    sp, dp = s // g_, d // g_
    R, TT, L = plan.r, plan.tile, plan.rows
    assert TT % (R * dp) == 0
    xp, wp = _pad_c(x), _pad_c(w)
    y = np.full((B, t_out, xp.shape[2]), np.nan)
    for tile in range(_cdiv(t_out, TT)):
        t0 = tile * TT
        planes = _stage(xp, t0, s, p, L, L, np.nan)
        n_t = min(TT, t_out - t0)
        for it in range(TT // R):
            f0 = (it // dp) * R * dp + it % dp
            if f0 >= n_t:
                continue
            acc = np.zeros((R,) + planes.shape[:1] + planes.shape[3:])
            for kr in range(min(sp, K)):
                n = _cdiv(K - kr, sp)
                r_, o = (kr * d) % s, (kr * d) // s
                win = np.full_like(acc, np.nan)  # V[m] in slot m % R
                for i in range(R - 1):
                    win[i] = _row(planes, r_, f0 + o + i * dp, L)
                nxt = R - 1
                for j in range(0, n, R):
                    for jj in range(R):
                        if j + jj >= n:
                            continue
                        win[(jj + R - 1) % R] = _row(planes, r_,
                                                     f0 + o + nxt * dp, L)
                        nxt += 1
                        wk = wp[kr + (j + jj) * sp]
                        acc += win[[(jj + i) % R for i in range(R)]] * wk
            for i in range(R):
                f = f0 + i * dp
                if f < n_t:
                    y[:, t0 + f] = acc[i]
    return y[:, :, :C]


def model_k5(x, g, K, s, d, p, plan):
    """dw as K5 computes it: a partial per (batch row, chunk), the sum of
    its items' register-window sums over the slices in order, then the
    partials in index order (all batch rows and channel blocks at once)."""
    B, T, C = x.shape
    t_out = g.shape[1]
    g_ = math.gcd(s, d)
    sp, dp = s // g_, d // g_
    R, TC, L = plan.r, plan.chunk, plan.rows
    chunks = _cdiv(t_out, TC)
    assert plan.partials == chunks * B
    subs = plan.slices * dp
    groups = [(kr, j0) for kr in range(min(sp, K))
              for j0 in range(0, _cdiv(K - kr, sp), R)]
    slice_ = _cdiv(TC, plan.slices)
    xp, gp = _pad_c(x), _pad_c(g)
    Cp = xp.shape[2]
    part = np.zeros((plan.partials, K, Cp))
    for ch in range(chunks):
        t0 = ch * TC
        n_t = min(TC, t_out - t0)
        acc_s = np.zeros((subs, K, B, Cp))
        planes = _stage(xp, t0, s, p, plan.staged, L, np.nan)
        g_s = np.zeros((B, TC, Cp))
        g_s[:, :n_t] = gp[:, t0:t0 + TC]
        for item in range(len(groups) * subs):
            sub = item % subs
            u, ts = sub % dp, sub // dp
            kr, j0 = groups[item // subs]
            n = _cdiv(K - kr, sp)
            fa = ts * slice_ + u
            fb = min((ts + 1) * slice_, n_t)
            if fa >= fb:
                continue
            steps = _cdiv(fb - fa, dp)
            r_ = (kr * d) % s
            base = fa + (kr * d) // s + j0 * dp  # V[m] = row base + m d'
            acc = np.zeros((R, B, Cp))
            win = np.full_like(acc, np.nan)
            for i in range(R - 1):
                win[i] = _row(planes, r_, base + i * dp, L)
            for m in range(0, steps, R):
                for mm in range(R):
                    if m + mm >= steps:
                        continue
                    win[(mm + R - 1) % R] = _row(
                        planes, r_, base + (m + mm + R - 1) * dp, L)
                    gv = g_s[:, fa + (m + mm) * dp]
                    acc += win[[(mm + j) % R for j in range(R)]] * gv
            for j in range(min(R, n - j0)):
                acc_s[sub, kr + (j0 + j) * sp] = acc[j]
        blk = acc_s[0]
        for sub in range(1, subs):  # the slices in order
            blk = blk + acc_s[sub]
        for b in range(B):
            part[b * chunks + ch] = blk[:, b]
    dw = part[0]
    for pt in part[1:]:  # index order, as the second launch sums
        dw = dw + pt
    return dw[:, :C]


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def _case(shape):
    """Seeded inputs of ``shape`` and the JAX lax conv's (y, dx, dw) at
    precision 'highest' (float32), once for the K4 and K5 tests."""
    B, T, C, K, s, d = shape
    x, w, g, p = _inputs(*shape, seed=sum(shape))

    def f(a, b):
        return depthwise_conv1d_xla(a, b, s, d, p, precision='highest')
    xj, wj = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    y, vjp = jax.vjp(f, xj, wj)
    dx, dw = vjp(jnp.asarray(g, jnp.float32))
    return (x, w, g, p), [np.asarray(a, np.float64) for a in (y, dx, dw)]


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_k4_model_matches_plain_and_jax(shape):
    B, T, C, K, s, d = shape
    (x, w, g, p), jax_out = _case(shape)
    t_out = out_length(T, K, s, d, p)
    y = model_k4(x, w, s, d, p, fwd_plan(t_out, K, s, d))
    assert not np.isnan(y).any()
    plain = depthwise_fwd_reference(torch.from_numpy(x), torch.from_numpy(w),
                                    s, d, p).numpy()
    assert _rel(y, plain) < RTOL
    assert _rel(y, jax_out[0]) < JAX_RTOL


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_k5_model_matches_plain_and_jax(shape):
    B, T, C, K, s, d = shape
    (x, w, g, p), jax_out = _case(shape)
    t_out = g.shape[1]
    dw = model_k5(x, g, K, s, d, p, wgrad_plan(B, t_out, K, s, d))
    assert not np.isnan(dw).any()
    plain = depthwise_wgrad_reference(torch.from_numpy(x),
                                      torch.from_numpy(g), K, s, d, p).numpy()
    assert _rel(dw, plain) < RTOL
    assert _rel(dw, jax_out[2]) < JAX_RTOL


@pytest.mark.parametrize('shape', DGRAD_SHAPES, ids=str)
def test_input_gradient_geometry_through_the_k4_model(shape, monkeypatch):
    """depthwise_dgrad's stride-1 K4 call (stuffed cotangent, flipped w,
    padding d(K-1) - p), with K4 replaced by the model."""
    B, T, C, K, s, d = shape
    (x, w, g, p), jax_out = _case(shape)
    calls = []

    def k4_model(xx, ww, s1, d1, p1):
        t1 = out_length(xx.shape[1], ww.shape[0], s1, d1, p1)
        calls.append((s1, d1, p1))
        return torch.from_numpy(model_k4(
            xx.numpy(), ww.numpy(), s1, d1, p1,
            fwd_plan(t1, ww.shape[0], s1, d1)))
    monkeypatch.setattr(depthwise, 'depthwise_fwd', k4_model)
    dx = depthwise_dgrad(torch.from_numpy(g), torch.from_numpy(w), T, s, d,
                         p).numpy()
    assert calls == [(1, d, d * (K - 1) - p)]
    xt = torch.from_numpy(x).requires_grad_()
    depthwise_fwd_reference(xt, torch.from_numpy(w), s, d, p).backward(
        torch.from_numpy(g))
    assert _rel(dx, xt.grad.numpy()) < RTOL
    assert _rel(dx, jax_out[1]) < JAX_RTOL


@pytest.mark.parametrize('r', [4, 8, 16])
@pytest.mark.parametrize('shape, tile, chunk', [
    ((5, 90, 40, 11, 2, 1), 32, 16),
    ((7, 70, 36, 9, 1, 2), 64, 32),
    ((3, 61, 32, 7, 3, 2), 16, 24)])
def test_models_at_every_window(shape, tile, chunk, r, monkeypatch):
    """Every R K5 is built for (and K4 at the same R, as tools/dw_sweep.py
    builds it), short tiles and chunks, stride 3 with dilation 2 (s'=3,
    d'=2)."""
    B, T, C, K, s, d = shape
    x, w, g, p = _inputs(*shape, seed=sum(shape) + r)
    t_out = g.shape[1]
    for name, value in [('FWD_R', r), ('FWD_TILE', tile),
                        ('WGRAD_CHUNK', chunk), ('WGRAD_R_CHOICES', (r,))]:
        monkeypatch.setattr(depthwise, name, value)
    plan4, plan5 = fwd_plan(t_out, K, s, d), wgrad_plan(B, t_out, K, s, d)
    assert plan4.r == plan5.r == r
    y = model_k4(x, w, s, d, p, plan4)
    dw = model_k5(x, g, K, s, d, p, plan5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert _rel(y, depthwise_fwd_reference(xt, wt, s, d, p).numpy()) < RTOL
    assert _rel(dw, depthwise_wgrad_reference(
        xt, torch.from_numpy(g), K, s, d, p).numpy()) < RTOL


def _blocks(shape):
    B, T, C, K, s, d = shape
    p = get_same_padding(K, s, d)
    t_out = out_length(T, K, s, d, p)
    f, w = fwd_plan(t_out, K, s, d), wgrad_plan(B, t_out, K, s, d)
    ct = _cdiv(C, CT)
    return f, w, _cdiv(t_out, f.tile) * ct * B, w.partials * ct


def test_plans_fill_the_card_at_c1():
    """C1 launches at least one block for each of the H100's 132 SMs in
    both kernels (the first K5 launched 64)."""
    _, _, k4_blocks, k5_blocks = _blocks(chip_smoke.DW_MAIN)
    assert k4_blocks >= 132 and k5_blocks >= 132


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_plans_fit_the_card(shape):
    f, w, _, _ = _blocks(shape)
    for plan in (f, w):
        assert 1 <= plan.warps <= depthwise.MAX_WARPS
        assert plan.smem <= _build.SMEM_LIMIT_BYTES
    assert f.r == depthwise.FWD_R
    assert w.r in depthwise.WGRAD_R_CHOICES


def test_a_geometry_over_the_shared_memory_limit_raises():
    for plan in (fwd_plan(400, 2000, 1, 4), wgrad_plan(2, 400, 2000, 1, 4)):
        assert plan.smem > _build.SMEM_LIMIT_BYTES
        with pytest.raises(ValueError, match='shared memory'):
            depthwise._check_smem(plan.smem, 2000, 1, 4)


def test_tile_constants_match_the_kernel_source():
    with open(SRC) as f:
        src = f.read()

    def const(name):
        m = re.search(rf'constexpr int {name} = (\d+);', src)
        assert m, name
        return int(m.group(1))
    assert const('CT') == depthwise.CT
    assert const('MAX_WARPS') == depthwise.MAX_WARPS
    m = re.search(r'#define DW_FWD_R (\d+)', src)
    assert m and int(m.group(1)) == depthwise.FWD_R
    wgrad = re.findall(r'DW_WGRAD_CASE\((\d+)\)', src)
    assert tuple(int(c) for c in wgrad) == depthwise.WGRAD_R_CHOICES
