"""A float64 numpy model of K2 and K3's lattice in registers
(``csrc/ctc_lattice.cuh``, ``ctc_alpha.cu``, ``ctc_beta.cu``), held against
the plain recursions (``ops/ctc.py``) and the JAX ``ctc_loss_pallas`` in
interpret mode.

The model walks the work as the kernels do: a row's positions
s = w*32*J + 32*j + lane over the planned warps; the neighbours s-1, s-2
(K2) or s+1, s+2 (K3) by lane rotations of one register, lanes at a
warp's edge taking the next register down (or up), register 0 (or J-1)
taking the neighbouring warp's edge from a double-buffered exchange; the
plain version's nested logaddexp; the frames read from a cp.async ring in
which a copy's rows hold NaN from its start until the wait that covers it
(so a read before the copy lands, or a slot overwritten before it is
read, shows); and K3's gradient pass: label positions counting-sorted by
label, each label's segment summed in order, the blank positions summed
per lane then by a butterfly. The plan's constants and the shuffles' lane
offsets are read from the CUDA sources, so the model and the kernels
cannot drift apart. An index fault in the scheme shows here, on the CPU,
before the card.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.ops.ctc_pallas import ctc_loss_pallas
from wav2letter_pytorch_tpu_torch.ops import ctc_kernel
from wav2letter_pytorch_tpu_torch.ops.ctc import ctc_beta_reference
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import ctc_alpha_reference

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(ctc_kernel.__file__), os.pardir, 'csrc')


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


LATTICE, ALPHA, BETA = (_source(n) for n in ('ctc_lattice.cuh',
                                             'ctc_alpha.cu', 'ctc_beta.cu'))


def _const(src, name):
    m = re.search(rf'constexpr int {name} = (\d+);', src)
    assert m, name
    return int(m.group(1))


TARGET_J, MAX_WARPS, MAX_J = (_const(LATTICE, k) for k in
                              ('TARGET_J', 'MAX_WARPS', 'MAX_J'))
F, NCH = _const(LATTICE, 'CHUNK_FRAMES'), _const(LATTICE, 'RING_CHUNKS')
GRAD_WARPS = _const(BETA, 'GRAD_WARPS')
_MT = re.search(r'return j <= (\d+) \? (\d+) : j <= (\d+) \? (\d+) : '
                r'(\d+);', LATTICE)
assert _MT, 'max_threads'


def _lane_offsets(src, *regs):
    """Lane offsets of the step's shuffles of registers ``regs``: lane i
    reads lane (i + offset) & 31."""
    out = []
    for reg in regs:
        found = re.findall(rf'__shfl_sync\(FULL_MASK, {reg}\[j\], '
                           rf'\(lane \+ (\d+)\) & 31\)', src)
        assert len(found) == 1, reg
        out.append(int(found[0]))
    return out


ALPHA_OFFSETS = _lane_offsets(ALPHA, 'al')       # pair k-1's label
BETA_OFFSETS = _lane_offsets(BETA, 'ub', 'ul')   # pair k+1
NEG_INF = -1e30
LANES = np.arange(32)


def max_threads(j):
    j1, t1, j2, t2, t3 = (int(x) for x in _MT.groups())
    return t1 if j <= j1 else t2 if j <= j2 else t3


def plan_warps(S, warps=0):
    """``ctc::plan_warps``: (warps a row, pairs a lane) for targets of
    width S, or None."""
    pairs = S + 1
    if warps == 0:
        warps = min(-(-pairs // (32 * TARGET_J)), MAX_WARPS)
    if not 1 <= warps <= MAX_WARPS:
        return None
    j = -(-pairs // (32 * warps))
    if j > MAX_J or 32 * warps > max_threads(j):
        return None
    return warps, j


def logaddexp(a, b):
    """``ctc::logaddexp``: torch's form, which the kernels nest as the
    plain version does."""
    m = np.maximum(a, b)
    return m + np.log1p(np.exp(-np.abs(a - b)))


def update(x, y, z):
    return logaddexp(logaddexp(x, y), z)


class Ring:
    """The shared frame ring: RING_CHUNKS slots of CHUNK_FRAMES frames.
    A copy's rows hold NaN from its start until a wait lands its group."""

    def __init__(self, L):
        self.rows = np.full((NCH * F, L), np.nan)
        self.groups, self.pending = [], []

    def copy(self, row, frames):
        self.rows[row:row + len(frames)] = np.nan
        self.pending.append((row, np.array(frames, np.float64)))

    def commit(self):
        self.groups.append(self.pending)
        self.pending = []

    def wait(self, n):
        while len(self.groups) > n:
            for row, frames in self.groups.pop(0):
                self.rows[row:row + len(frames)] = frames


def _pairs(W, J):
    """Pair k of each (warp, register, lane): blank 2k, label 2k+1."""
    return (np.arange(W)[:, None, None] * 32 * J
            + np.arange(J)[None, :, None] * 32 + LANES[None, None, :])


def _first(W, J):
    """Each register's first pair, [W, J, 1]."""
    return (np.arange(W)[:, None] * 32 * J
            + 32 * np.arange(J)[None, :])[..., None]


def _row_setup(tg_b, tl_b, S, L):
    tl = int(min(max(tl_b, 0), S))
    tgc = np.clip(np.asarray(tg_b[:tl], np.int64), 0, L - 1)
    return tl, tgc


def _labels(tgc, k, tl):
    """tgc[k] where 0 <= k < tl (else 0)."""
    return tgc[np.clip(k, 0, max(tl - 1, 0))] if tl else np.zeros_like(k)


def _store(out, t, k, values_b, values_l, n, act):
    keep = act & (2 * k < n)
    out[t, 2 * k[keep]] = values_b[keep]
    keep = act & (2 * k + 1 < n)
    out[t, 2 * k[keep] + 1] = values_l[keep]
    assert not np.isnan(out[t, :n]).any()


def model_alpha_row(lp_b, ll_b, tg_b, tl_b, S, blank, warps=0):
    """K2 on one row: (nll, alphas [T, 2S+1], NaN where not stored)."""
    T, L = lp_b.shape
    n_alloc = 2 * S + 1
    W, J = plan_warps(S, warps)
    tl, tgc = _row_setup(tg_b, tl_b, S, L)
    n = 2 * tl + 1
    t_end = max(min(int(ll_b), T), 1)
    ring = Ring(L)

    def load_chunk(c):
        lo = c * F
        frames = min(F, t_end - lo)
        if frames > 0:
            ring.copy((c % NCH) * F, lp_b[lo:lo + frames])
        ring.commit()

    for c in range(NCH):
        load_chunk(c)
    k = _pairs(W, J)
    first = _first(W, J)
    beyond = first > tl      # never updated: nothing may read them
    lab = np.where(k < tl, _labels(tgc, k, tl), blank)
    skip = (k < tl) & (k >= 1) & (lab != _labels(tgc, k - 1, tl))
    ring.wait(NCH - 1)
    frame = ring.rows[0]
    ab = np.where(k == 0, frame[blank], NEG_INF)
    al = np.where((k == 0) & (tl > 0), frame[lab], NEG_INF)
    alphas = np.full((T, n_alloc), np.nan)
    _store(alphas, 0, k, ab, al, n, True)
    ab, al = np.where(beyond, np.nan, ab), np.where(beyond, np.nan, al)
    edge = np.full((2, MAX_WARPS), np.nan)
    if W > 1:
        edge[0, :W] = al[:, J - 1, 31]
    (offset,) = ALPHA_OFFSETS
    for t in range(1, t_end):
        if t % F == 0:
            load_chunk(t // F + NCH - 1)
        frame = ring.rows[(t // F % NCH) * F + t % F]
        e_prev = np.full(W, NEG_INF)
        e_prev[1:] = edge[(t - 1) & 1, :W - 1]   # previous warp's top label
        r = al[..., (LANES + offset) & 31]
        prev = r.copy()                          # pair k-1's label
        prev[:, 1:, 0] = r[:, :-1, 0]
        prev[:, 0, 0] = e_prev
        nb = logaddexp(ab, prev) + frame[blank]
        nl = update(al, ab, np.where(skip, prev, NEG_INF)) + frame[lab]
        ab, al = np.where(beyond, ab, nb), np.where(beyond, al, nl)
        _store(alphas, t, k, ab, al, n, True)
        if W > 1:
            edge[t & 1, :W] = al[:, J - 1, 31]
        if (t + 1) % F == 0:
            ring.wait(NCH - 2)
    fin_blank = ab[k == tl][0]
    fin_label = al[k == tl - 1][0] if tl > 0 else NEG_INF
    return -logaddexp(fin_blank, fin_label), alphas


def counting_sort(tgc, L):
    """The chain's sort of label positions 2i+1 by label, stable."""
    counts = np.array([(tgc == l).sum() for l in range(L)], np.int64)
    off = np.concatenate([[0], np.cumsum(counts)])
    perm = np.zeros(len(tgc), np.int64)
    for l in range(L):
        k = off[l]
        for i in range(len(tgc)):
            if tgc[i] == l:
                perm[k] = 2 * i + 1
                k += 1
    return perm, off


def model_beta_row(lp_b, al_b, nll_b, g_b, ll_b, tg_b, tl_b, S, blank,
                   warps=0):
    """K3 on one row: (a) the beta chain, (b) the per-label sums."""
    T, L = lp_b.shape
    grad = np.zeros((T, L))
    if g_b == 0:
        return grad
    n_alloc = 2 * S + 1
    W, J = plan_warps(S, warps)
    tl, tgc = _row_setup(tg_b, tl_b, S, L)
    n = 2 * tl + 1
    t_end = max(min(int(ll_b), T), 1)
    t_last = t_end - 1
    ring = Ring(L)

    def load_chunk(c):
        hi = t_last - c * F
        lo_slot = hi - F + 1
        lo = max(lo_slot, 0)
        if hi >= 0:
            ring.copy((c % NCH) * F + lo - lo_slot, lp_b[lo:hi + 1])
        ring.commit()

    for c in range(NCH):
        load_chunk(c)
    perm, off = counting_sort(tgc, L)
    k = _pairs(W, J)
    first = _first(W, J)
    beyond = first > tl      # never updated: nothing may read them
    lab = np.where(k < tl, _labels(tgc, k, tl), blank)
    skip = (k + 1 < tl) & (_labels(tgc, k + 1, tl) != lab)
    inner = k < tl           # u[2k+1] and u[2k+2] are positions of the row
    ring.wait(NCH - 1)
    beta = np.full((T, n_alloc), np.nan)
    bb = np.where(k == tl, 0.0, NEG_INF)
    bl = np.where(k == tl - 1, 0.0, NEG_INF)
    _store(beta, t_last, k, bb, bl, n, True)
    frame = ring.rows[F - 1]
    ub = np.where(beyond, np.nan, bb + frame[blank])
    ul = np.where(beyond, np.nan, bl + frame[lab])
    edge = np.full((2, MAX_WARPS, 2), np.nan)
    if W > 1:
        edge[0, :W] = np.stack([ub[:, 0, 0], ul[:, 0, 0]], -1)
    offsets = BETA_OFFSETS
    for step in range(1, t_last + 1):
        t = t_last - step
        if step % F == 0:
            load_chunk(step // F + NCH - 1)
        nb_edge = np.full(W, NEG_INF)
        nl_edge = np.full(W, NEG_INF)
        nb_edge[:-1] = edge[(step - 1) & 1, 1:W, 0]   # next warp's bottom
        nl_edge[:-1] = edge[(step - 1) & 1, 1:W, 1]   # pair
        rb = ub[..., (LANES + offsets[0]) & 31]
        rl = ul[..., (LANES + offsets[1]) & 31]
        nxb, nxl = rb.copy(), rl.copy()                # pair k+1
        nxb[:, :-1, 31] = rb[:, 1:, 31]
        nxl[:, :-1, 31] = rl[:, 1:, 31]
        nxb[:, -1, 31] = nb_edge
        nxl[:, -1, 31] = nl_edge
        bb = logaddexp(ub, np.where(inner, ul, NEG_INF))
        bl = update(ul, np.where(inner, nxb, NEG_INF),
                    np.where(skip, nxl, NEG_INF))
        _store(beta, t, k, bb, bl, n, True)
        frame = ring.rows[(step // F % NCH) * F + F - 1 - step % F]
        ub = np.where(beyond, ub, bb + frame[blank])
        ul = np.where(beyond, ul, bl + frame[lab])
        if W > 1:
            edge[step & 1, :W] = np.stack([ub[:, 0, 0], ul[:, 0, 0]], -1)
        if (step + 1) % F == 0:
            ring.wait(NCH - 2)
    # (b): one warp a frame, gamma in shared memory.
    logz = -nll_b
    gam = np.exp(al_b[:t_end, :n] + beta[:t_end, :n] - logz)
    part = np.zeros((t_end, 32))
    for k in range(-(-n // 32)):          # each lane's blanks, ascending s
        for lane in range(0, 32, 2):
            if lane + 32 * k < n:
                part[:, lane] = part[:, lane] + gam[:, lane + 32 * k]
    for o in (16, 8, 4, 2, 1):            # warp_sum's butterfly
        part = part + part[:, LANES ^ o]
    assert (part == part[:, :1]).all()   # every lane holds the same sum
    for l in range(L):
        total = part[:, 0].copy() if l == blank else np.zeros(t_end)
        for k in range(off[l], off[l + 1]):
            total = total + gam[:, perm[k]]
        grad[:t_end, l] = -(g_b * total)
    return grad


def model(lp, ll, tg, tl, g, blank=0, warps=0):
    """K2 then K3 over the batch: (nll [B], alphas, grad [B, T, L])."""
    B, T, L = lp.shape
    S = tg.shape[1]
    nll = np.zeros(B)
    alphas = np.zeros((B, T, 2 * S + 1))
    grad = np.zeros((B, T, L))
    for b in range(B):
        nll[b], alphas[b] = model_alpha_row(lp[b], ll[b], tg[b], tl[b], S,
                                            blank, warps)
        grad[b] = model_beta_row(lp[b], alphas[b], nll[b], g[b], ll[b],
                                 tg[b], tl[b], S, blank, warps)
    return nll, alphas, grad


def _inputs(seed, B, T, L, S, ll=(None, None), tl=(1, None), labels=None):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, L))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lo, hi = ll
    ll_ = rng.integers(T // 2 if lo is None else lo,
                       (T if hi is None else hi) + 1, size=B)
    tl_ = rng.integers(tl[0], (S if tl[1] is None else tl[1]) + 1, size=B)
    pool = np.arange(1, L) if labels is None else np.asarray(labels)
    tg = rng.choice(pool, size=(B, S)) if S else np.zeros((B, 0), np.int64)
    tg = np.where(np.arange(S)[None] < tl_[:, None], tg, 0)
    g = rng.uniform(0.5, 2.0, size=B)
    return lp, ll_.astype(np.int32), tg.astype(np.int32), \
        tl_.astype(np.int32), g


def _check_against_plain(inputs, warps=0):
    lp, ll, tg, tl, g = inputs
    B, T, L = lp.shape
    args = (torch.from_numpy(lp), torch.from_numpy(ll), torch.from_numpy(tg),
            torch.from_numpy(tl))
    nll_p, al_p = ctc_alpha_reference(*args, store_alphas=True)
    # zero_infinity: an impossible row's upstream gradient is 0
    g = np.where(nll_p.numpy() >= 0.5e30, 0.0, g)
    grad_p = ctc_beta_reference(args[0], al_p, nll_p, *args[1:],
                                torch.from_numpy(g)).numpy()
    nll_p, al_p = nll_p.numpy(), al_p.numpy()
    nll_m, al_m, grad_m = model(lp, ll, tg, tl, g, warps=warps)
    np.testing.assert_allclose(nll_m, nll_p, rtol=1e-10, atol=1e-9)
    t_end = np.clip(ll, 1, T)
    for b in range(B):
        n = 2 * min(max(int(tl[b]), 0), tg.shape[1]) + 1
        got, want = al_m[b, :t_end[b], :n], al_p[b, :t_end[b], :n]
        assert not np.isnan(got).any()
        assert (np.abs(got - want)
                <= 1e-10 * np.maximum(1.0, np.abs(want))).all()
    assert not np.isnan(grad_m).any()
    scale = max(np.abs(grad_p).max(), 1e-30)
    assert np.abs(grad_m - grad_p).max() <= 1e-10 * scale
    return nll_m, grad_m


# (B, T, L, S, logit-length range, target-length range, label pool)
SEMANTIC = {
    'ragged': (4, 30, 6, 8, (15, None), (1, None), None),
    'repeated_labels': (3, 40, 4, 10, (30, None), (6, None), [2, 2, 2, 3]),
    'empty_targets': (3, 12, 5, 2, (1, None), (0, 0), None),
    'T_equals_1': (4, 1, 5, 2, (1, 1), (0, None), None),
    'logit_length_over_T': (3, 20, 6, 6, (21, 30), (2, None), None),
    'impossible': (4, 5, 5, 5, (2, 5), (4, None), [1, 1, 2]),
    # S_b = S = 32: the second warp holds only the final blank (pair 32)
    'final_blank_alone': (2, 70, 6, 32, (66, None), (32, 32), None),
}


@pytest.mark.parametrize('case', sorted(SEMANTIC))
def test_model_matches_plain_edge_semantics(case):
    B, T, L, S, ll, tl, labels = SEMANTIC[case]
    inputs = _inputs(len(case), B, T, L, S, ll, tl, labels)
    nll, grad = _check_against_plain(inputs)
    if case == 'impossible':
        assert (nll >= 0.5e30).any() and (grad == 0).all()


def _threshold_sizes():
    """S on both sides of the table's changes from one warp a row to two,
    four to five, sixteen to seventeen and one pair a lane to two, and the
    largest S the design takes."""
    sizes = []
    S = 1
    while plan_warps(S):
        (w0, j0), (w1, j1) = plan_warps(S - 1), plan_warps(S)
        if j1 != j0 or (w1 != w0 and w0 in (1, 4, 16)):
            sizes += [S - 1, S]
        S += 1
    return sizes + [S - 1]


@pytest.mark.parametrize('S', _threshold_sizes())
def test_model_matches_plain_at_warp_thresholds(S):
    W, J = plan_warps(S)
    assert 32 * W * J >= S + 1
    # enough frames for any target with repeats, ragged lengths
    inputs = _inputs(S, 2, 2 * S + 4, 5, S, (2 * S + 2, None), (S - 2, None))
    _check_against_plain(inputs)


@pytest.mark.parametrize('warps', [1, 2, 4, 16])
def test_model_matches_plain_off_the_table(warps):
    """The main path's lattice (S = 144: the table's 5 warps, 1 pair a
    lane) at other warps a row: 5, 3, 2 and 1 pairs a lane."""
    assert plan_warps(144) == (5, 1)
    inputs = _inputs(warps, 2, 300, 29, 144, (290, None), (120, None))
    _check_against_plain(inputs, warps=warps)


def test_plan_limits():
    """The table's largest lattice, which the wrappers' ValueError and the
    kernels' plan_warps state, and a sweep's depths."""
    assert plan_warps(2047) == (32, 2)
    assert plan_warps(2048) is None
    assert plan_warps(144, 1) == (1, 5)
    assert plan_warps(320, 1) is None          # 11 pairs a lane
    assert plan_warps(1024) == (32, 2)
    assert GRAD_WARPS * 32 <= 1024
    # The kernels index the ring as frame t % (F * RING_CHUNKS) (K2) and
    # (i ^ (F - 1)) % (F * RING_CHUNKS) (K3): the slot and row the model
    # reads, for F a power of two.
    assert F & (F - 1) == 0 and NCH & (NCH - 1) == 0
    for i in range(4 * F * NCH):
        assert (i // F % NCH) * F + i % F == i % (F * NCH)
        assert (i // F % NCH) * F + F - 1 - i % F == (i ^ (F - 1)) % (F * NCH)


def test_logaddexp_form_and_missing_neighbours():
    """The kernels' logaddexp is torch's (the plain version's) form, and a
    NEG_INF neighbour adds exactly nothing, also in float32."""
    assert 'return m + log1p_unit(expf(-fabsf(a - b)));' in LATTICE
    vals = np.array([NEG_INF, -1e4, -30.0, -2.5, 0.0, 3.0])
    a, b, c = np.meshgrid(vals, vals, vals, indexing='ij')
    want = np.logaddexp(np.logaddexp(a, b), c)
    assert np.allclose(update(a, b, c), want, rtol=1e-12, atol=0)
    assert (update(vals, NEG_INF, NEG_INF) == vals).all()
    v32 = vals.astype(np.float32)
    neg = np.float32(NEG_INF)
    m = np.maximum(v32, neg)
    got = m + np.log1p(np.exp(-np.abs(v32 - neg)))
    assert got.dtype == np.float32 and (got == v32).all()


def test_counting_sort_orders_positions_by_label_stably():
    rng = np.random.default_rng(0)
    tgc = rng.integers(0, 6, size=40)
    perm, off = counting_sort(tgc, 6)
    labels = tgc[(perm - 1) // 2]
    assert (np.diff(labels) >= 0).all()
    for l in range(6):
        seg = perm[off[l]:off[l + 1]]
        assert (np.diff(seg) > 0).all() and (tgc[(seg - 1) // 2] == l).all()
    assert sorted(perm) == list(range(1, 80, 2))


@functools.lru_cache(maxsize=None)
def _pallas_value_and_grad():
    def loss(x, ll, tg, tl, w):
        per = ctc_loss_pallas(x, ll, tg, tl, reduction='none',
                              interpret=True, block_b=4)
        return jnp.sum(w * per), per
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize('case', ['ragged', 'repeated_labels', 'T_equals_1',
                                  'logit_length_over_T', 'impossible'])
def test_model_matches_pallas_kernel_interpret(case):
    """nll (zero_infinity) and the gradient of sum(w * loss) against the
    TPU kernels run in interpret mode in float32."""
    B, T, L, S, ll, tl, labels = SEMANTIC[case]
    lp, ll, tg, tl, w = _inputs(len(case), B, T, L, S, ll, tl, labels)
    lp32 = lp.astype(np.float32)
    (_, per), grad_j = _pallas_value_and_grad()(
        lp32, ll, tg, tl, w.astype(np.float32))
    nll, _, _ = model(lp32.astype(np.float64), ll, tg, tl, np.zeros(B))
    loss = np.where(nll >= 0.5e30, 0.0, nll)
    g = np.where(nll >= 0.5e30, 0.0, w)
    _, _, grad = model(lp32.astype(np.float64), ll, tg, tl, g)
    np.testing.assert_allclose(loss, np.asarray(per), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grad, np.asarray(grad_j), rtol=1e-4,
                               atol=1e-5)
