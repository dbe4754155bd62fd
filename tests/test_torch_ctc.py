"""Port CTC (plain recursion = kernel K2's plain version) vs the JAX package.

The same seeded numpy log-probs go through the JAX scan (``ops/ctc.py``),
the Pallas kernel in interpret mode (``ctc_loss_pallas``, block_b=4) and
the port's ``ctc_loss`` / ``ctc_loss_kernel`` on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from wav2letter_pytorch_tpu.ops.ctc_pallas import ctc_loss_pallas
from wav2letter_pytorch_tpu_torch.ops.ctc import ctc_loss
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import (ctc_alpha,
                                                         ctc_alpha_reference,
                                                         ctc_loss_kernel)

torch.set_num_threads(1)

# jit: one compiled program per shape instead of op-by-op interpretation
pallas_ctc = jax.jit(functools.partial(ctc_loss_pallas, interpret=True,
                                       block_b=4),
                     static_argnames=('reduction',))

scan_ctc = jax.jit(jax_ctc_loss, static_argnames=('reduction',))

# Both sides run the same float32 log-space recursion; logaddexp is written
# differently (nested vs max-shifted in the Pallas kernel), so allow a few
# ulps of the per-sample loss (~10-100 in magnitude).
RTOL = 1e-5
ATOL = 1e-4


def _case(rng, B=4, T=18, L=6, S=5, min_tlen=8, min_tl=1):
    logits = rng.standard_normal((B, T, L)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    ll = rng.integers(min_tlen, T + 1, size=B).astype(np.int32)
    tl = rng.integers(min_tl, S + 1, size=B).astype(np.int32)
    tg = rng.integers(1, L, size=(B, S)).astype(np.int32)
    for b in range(B):
        tg[b, tl[b]:] = 0
    return lp, ll, tg, tl


def _port(fn, lp, ll, tg, tl, **kw):
    with torch.no_grad():
        return fn(torch.from_numpy(lp), torch.from_numpy(ll),
                  torch.from_numpy(tg), torch.from_numpy(tl), **kw).numpy()


CASES = {
    'ragged': dict(),
    'full_length': dict(min_tlen=18),
    'empty_targets': dict(min_tl=0, S=3),
    'impossible': dict(T=4, S=5, min_tlen=1, min_tl=4),
    't_equals_1': dict(T=1, S=2, min_tlen=1, min_tl=0),
    'long': dict(B=4, T=60, L=10, S=20, min_tlen=40),
}


REDUCTIONS = ('none', 'mean', 'sum')


@functools.lru_cache(maxsize=None)
def _jax_scan(case):
    """A case's inputs and the JAX scan's loss under every reduction, from
    one compiled program (compiling per reduction would triple the time)."""
    inputs = _case(np.random.default_rng(0), **CASES[case])
    fn = jax.jit(lambda *a: {r: jax_ctc_loss(*a, reduction=r)
                             for r in REDUCTIONS})
    return inputs, {r: np.asarray(v) for r, v in fn(*inputs).items()}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('reduction', REDUCTIONS)
def test_ctc_matches_jax_scan(case, reduction):
    (lp, ll, tg, tl), refs = _jax_scan(case)
    ref = refs[reduction]
    np.testing.assert_allclose(
        _port(ctc_loss, lp, ll, tg, tl, reduction=reduction), ref,
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _port(ctc_loss_kernel, lp, ll, tg, tl, reduction=reduction), ref,
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_k2_matches_pallas_kernel_interpret(case):
    lp, ll, tg, tl = _case(np.random.default_rng(1), **CASES[case])
    ref = np.asarray(pallas_ctc(lp, ll, tg, tl, reduction='none'))
    ours = _port(ctc_loss_kernel, lp, ll, tg, tl, reduction='none')
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_repeated_labels_need_separating_blanks():
    """'aaa' needs 2*3-1 = 5 frames: 4 frames is impossible (zeroed), 5 is
    finite; both sides agree."""
    rng = np.random.default_rng(2)
    for T, possible in ((4, False), (5, True)):
        lp = np.array(jax.nn.log_softmax(jnp.asarray(
            rng.standard_normal((4, T, 5)).astype(np.float32)), -1))
        tg = np.full((4, 3), 2, np.int32)
        ll = np.full((4,), T, np.int32)
        tl = np.full((4,), 3, np.int32)
        raw = _port(ctc_alpha, lp, ll, tg, tl)
        assert np.all(raw < 1e29) == possible
        ours = _port(ctc_loss_kernel, lp, ll, tg, tl, reduction='none')
        for ref in (scan_ctc(lp, ll, tg, tl, reduction='none'),
                    pallas_ctc(lp, ll, tg, tl, reduction='none')):
            np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL,
                                       atol=ATOL)


def test_plain_k2_matches_torch_ctc_loss():
    """The port's recursion against torch's own CTC on the same inputs."""
    lp, ll, tg, tl = _case(np.random.default_rng(3), B=4, T=30, L=8, S=6)
    ours = _port(ctc_alpha, lp, ll, tg, tl)
    ref = torch.nn.functional.ctc_loss(
        torch.from_numpy(lp).transpose(0, 1), torch.from_numpy(tg),
        torch.from_numpy(ll), torch.from_numpy(tl), reduction='none',
        zero_infinity=True)
    np.testing.assert_allclose(ours, ref.numpy(), rtol=RTOL, atol=ATOL)


def test_plain_k2_float64_oracle():
    lp, ll, tg, tl = _case(np.random.default_rng(4), T=40, S=10, min_tlen=30)
    ours = _port(ctc_alpha, lp, ll, tg, tl)
    oracle = _port(ctc_alpha_reference, lp.astype(np.float64), ll, tg, tl)
    np.testing.assert_allclose(ours, oracle, rtol=RTOL, atol=ATOL)


def test_k2_wrapper_refuses_gradients_and_counts_only_launches():
    lp, ll, tg, tl = _case(np.random.default_rng(5))
    x = torch.from_numpy(lp).requires_grad_()
    with pytest.raises(NotImplementedError, match='no backward'):
        ctc_alpha(x, torch.from_numpy(ll), torch.from_numpy(tg),
                  torch.from_numpy(tl))
    before = ctc_alpha.launches
    _port(ctc_alpha, lp, ll, tg, tl)
    assert ctc_alpha.launches == before  # plain path on the CPU
