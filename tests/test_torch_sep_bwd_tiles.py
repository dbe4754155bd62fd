"""A numpy model of K7's tiling (``csrc/sep_conv.cu``), held against the
plain K7 (``sep_bwd_reference``) in float64.

The model walks the work as the kernels do: (ii) blocks of ``DW_TT``-frame
time tiles per batch row, each tile staged with its halo (x*m1 from
t0 - p, gdw from t0 - pt, zero outside the sequence), dx and dwres masked
by m1 and m2, dwdw summed per block over the frames before len2 and the
blocks' partials summed in index order; (iii) the B*T_out rows of dwpw's
reduction in ``bwd_plan``'s runs, one partial each, summed in index order.
So an index fault in the tiling shows here, on the CPU, before the card.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from wav2letter_pytorch_tpu_torch.ops import sep_conv
from wav2letter_pytorch_tpu_torch.ops.sep_conv import (bwd_plan,
                                                       out_length,
                                                       sep_bwd_reference)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(sep_conv.__file__), os.pardir, 'csrc',
                   'sep_conv.cu')
TT = sep_conv.DW_TT
# float64 on both sides: only the summation order differs.
RTOL = 1e-12
# (B, T, Cin, Cout, K, d), same padding: chip_smoke's edges of K6's tiles
# and of K7's, T_out one short of a time tile, one tile, one over, two
# tiles and one over (a block walks more than one tile), shorter than a
# tile, and QuartzNet's C2 (K = 87, d = 2).
SHAPES = (chip_smoke.SEP_EDGE + chip_smoke.SEP_BWD_EDGE
          + [(2, TT - 1, 48, 64, 33, 1), (2, TT, 48, 64, 33, 1),
             (2, TT + 1, 48, 64, 33, 1), (32, 2 * TT + 1, 64, 32, 9, 1),
             (3, TT // 2, 40, 24, 11, 1), (2, TT + 1, 40, 48, 87, 2)])


def _inputs(B, T, Cin, Cout, K, d, seed):
    (x, wdw, wpw, g), l1, l2, p = chip_smoke.sep_inputs(
        B, T, Cin, Cout, K, d, seed, torch.device('cpu'))
    return [t.double().numpy() for t in (x, wdw, wpw, g)], l1, l2, p


def model_ii(x, gdw, wdw, l1, l2, d, p, time_groups, tiles_per_block):
    """(dx, dwres, dwdw) as K7 (ii) computes them, tile by tile."""
    B, T, C = x.shape
    K = wdw.shape[0]
    t_out = gdw.shape[1]
    pt = d * (K - 1) - p
    n_tiles = -(-max(T, t_out) // TT)
    rows = TT + d * (K - 1)
    dx = np.full((B, T, C), np.nan)
    dwres = np.full((B, t_out, C), np.nan)
    parts = np.zeros((B * time_groups, K, C))
    for b in range(B):
        for tg in range(time_groups):
            first = tg * tiles_per_block
            for tile in range(first, min(first + tiles_per_block, n_tiles)):
                t0 = tile * TT
                xs = np.zeros((rows, C))
                gs = np.zeros((rows, C))
                for r in range(rows):
                    if 0 <= t0 - p + r < l1[b]:
                        xs[r] = x[b, t0 - p + r]
                    if 0 <= t0 - pt + r < t_out:
                        gs[r] = gdw[b, t0 - pt + r]
                a = sum(xs[k * d:k * d + TT] * wdw[k] for k in range(K))
                bk = sum(gs[k * d:k * d + TT] * wdw[K - 1 - k]
                         for k in range(K))
                t = t0 + np.arange(TT)
                keep = t < t_out
                dwres[b, t[keep]] = np.where((t < l2[b])[:, None], a,
                                             0.0)[keep]
                keep = t < T
                dx[b, t[keep]] = np.where((t < l1[b])[:, None], bk,
                                          0.0)[keep]
                n_t = max(0, min(TT, l2[b] - t0))
                for k in range(K):
                    parts[b * time_groups + tg, k] += (
                        xs[k * d:k * d + n_t] * gs[pt:pt + n_t]).sum(0)
    dwdw = np.zeros((K, C))
    for part in parts:  # fixed order, as partials.cuh sums
        dwdw = dwdw + part
    return dx, dwres, dwdw


def model_iii(dwres, g, splits, rows_per_split):
    """dwpw as K7 (iii) and (v) compute it: a partial per run of rows."""
    a = dwres.reshape(-1, dwres.shape[-1])
    b = g.reshape(-1, g.shape[-1])
    dwpw = np.zeros((a.shape[1], b.shape[1]))
    for z in range(splits):
        r = slice(z * rows_per_split, (z + 1) * rows_per_split)
        dwpw = dwpw + a[r].T @ b[r]
    return dwpw


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_tiling_model_matches_plain_k7(shape):
    B, T, Cin, Cout, K, d = shape
    (x, wdw, wpw, g), l1, l2, p = _inputs(*shape, seed=sum(shape))
    t_out = out_length(T, K, d, p)
    plan = bwd_plan(B, T, t_out, Cin, Cout)
    l1n, l2n = l1.numpy(), l2.numpy()
    m2 = (np.arange(t_out)[None, :] < l2n[:, None])[..., None]
    gdw = (g @ wpw.T) * m2  # K7 (i)
    dx, dwres, dwdw = model_ii(x, gdw, wdw, np.minimum(l1n, T),
                               np.minimum(l2n, t_out), d, p,
                               plan.time_groups, plan.tiles_per_block)
    dwpw = model_iii(dwres, g, plan.pw_splits, plan.pw_rows)
    want = sep_bwd_reference(torch.from_numpy(x), l1, l2,
                             torch.from_numpy(wdw), torch.from_numpy(wpw),
                             torch.from_numpy(g), d, p)
    for name, got, ref in zip(('dx', 'dwdw', 'dwpw'), (dx, dwdw, dwpw),
                              want):
        assert not np.isnan(got).any(), name
        assert _rel(got, ref.numpy()) < RTOL, name


@pytest.mark.parametrize('B, T, Cin, Cout', [
    (32, 404, 256, 256), (32, 404, 256, 512), (32, 404, 512, 512),
    (2, 63, 48, 200), (16, 301, 500, 130), (1, 1, 1, 1), (3, 5000, 64, 640),
    (64, 129, 1000, 7)])
def test_plan_covers_every_tile_and_row_once(B, T, Cin, Cout):
    t_out = T
    plan = bwd_plan(B, T, t_out, Cin, Cout)
    n_tiles = -(-T // TT)
    tiles = [tg * plan.tiles_per_block + i for tg in range(plan.time_groups)
             for i in range(plan.tiles_per_block)
             if tg * plan.tiles_per_block + i < n_tiles]
    assert tiles == list(range(n_tiles))
    assert (plan.time_groups - 1) * plan.tiles_per_block < n_tiles
    rows = B * t_out
    assert plan.pw_rows % sep_conv.PW_BK == 0
    assert (plan.pw_splits - 1) * plan.pw_rows < rows <= \
        plan.pw_splits * plan.pw_rows
    tiles_pw = -(-Cin // sep_conv.PW_BM) * -(-Cout // sep_conv.PW_BN)
    assert plan.pw_splits * tiles_pw <= max(sep_conv.PW_TARGET_BLOCKS,
                                            tiles_pw)


def test_tile_constants_match_the_kernel_source():
    with open(SRC) as f:
        src = f.read()

    def const(name):
        m = re.search(rf'constexpr int {name} = (\d+);', src)
        assert m, name
        return int(m.group(1))
    assert const('DW_TT') == sep_conv.DW_TT
    assert const('DW_CG') == sep_conv.DW_CG
    assert const('PW_BM') == sep_conv.PW_BM
    assert const('PW_BN') == sep_conv.PW_BN
    assert const('PW_BK') == sep_conv.PW_BK

