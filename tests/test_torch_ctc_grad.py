"""The port's CTC gradient (``CTCLoss``: K2 forward with stored alphas, K3
backward, their plain versions on the CPU) vs the JAX package.

The same seeded numpy log-probs go through ``jax.grad`` of the JAX scan
(``ops/ctc.py``) and of the Pallas kernels in interpret mode
(``ctc_loss_pallas``, block_b=4), and through the port's autograd on the
CPU. A random weight per row makes the upstream gradient of each row's
nll differ, so the backward's per-row scaling is exercised too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from wav2letter_pytorch_tpu.ops.ctc_pallas import ctc_loss_pallas
from wav2letter_pytorch_tpu_torch.ops.ctc import (ctc_beta_reference,
                                                  ctc_forward_alphas)
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import (CTCLoss, ctc_alpha,
                                                         ctc_beta,
                                                         ctc_loss_kernel)

torch.set_num_threads(1)

# The gate of the TPU kernel checks (scripts/run_tpu_checks.py:52-58).
# Both sides run float32 log-space recursions with logaddexp written
# differently (and JAX differentiates through it), so they agree to ~1e-6.
TOL = 1e-4


def _case(rng, B=4, T=18, L=6, S=5, min_tlen=8, min_tl=1, repeat=False):
    logits = rng.standard_normal((B, T, L)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    ll = rng.integers(min_tlen, T + 1, size=B).astype(np.int32)
    tl = rng.integers(min_tl, S + 1, size=B).astype(np.int32)
    tg = rng.integers(1, L, size=(B, S)).astype(np.int32)
    if repeat:  # runs of one label: the skip transition is forbidden there
        tg[:, 1::2] = tg[:, 0::2][:, :tg[:, 1::2].shape[1]]
    for b in range(B):
        tg[b, tl[b]:] = 0
    weights = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
    return lp, ll, tg, tl, weights


CASES = {
    'ragged': dict(),
    'empty_target': dict(min_tl=0, S=3),
    # rows needing more frames than they have: zero_infinity zeroes them
    'impossible': dict(T=6, S=5, min_tlen=2, min_tl=4),
    't_equals_1': dict(T=1, S=2, min_tlen=1, min_tl=0),
    'repeated_labels': dict(T=24, S=6, min_tlen=16, repeat=True),
}


def _jax_loss(fn):
    def loss(x, ll, tg, tl, w):
        return jnp.sum(w * fn(x, ll, tg, tl, reduction='none'))
    return jax.jit(jax.value_and_grad(loss))


JAX_GRADS = {
    'scan': _jax_loss(jax_ctc_loss),
    'pallas': _jax_loss(lambda *a, **k: ctc_loss_pallas(
        *a, interpret=True, block_b=4, **k)),
}


def _port_grad(lp, ll, tg, tl, w):
    x = torch.from_numpy(lp).requires_grad_()
    per = ctc_loss_kernel(x, torch.from_numpy(ll), torch.from_numpy(tg),
                          torch.from_numpy(tl), reduction='none')
    loss = torch.sum(torch.from_numpy(w) * per)
    loss.backward()
    return float(loss.detach()), x.grad.numpy(), per.detach().numpy()


@pytest.mark.parametrize('impl', sorted(JAX_GRADS))
@pytest.mark.parametrize('case', sorted(CASES))
def test_ctc_grad_matches_jax(case, impl):
    lp, ll, tg, tl, w = _case(np.random.default_rng(0), **CASES[case])
    value, grad = JAX_GRADS[impl](lp, ll, tg, tl, w)
    ours_value, ours, per = _port_grad(lp, ll, tg, tl, w)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours_value, float(value), rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(ours, np.asarray(grad), rtol=0, atol=TOL)
    # frames at or past each row's length get no gradient
    for b in range(len(ll)):
        assert not ours[b, max(int(ll[b]), 1):].any()
    if case == 'impossible':
        zeroed = per == 0
        assert zeroed.any() and (~zeroed).any()
        assert not ours[zeroed].any()   # exact zeros, not 0 * inf


def test_grad_of_mean_reduction_matches_jax():
    lp, ll, tg, tl, _ = _case(np.random.default_rng(1), B=4, T=40, L=8, S=9,
                              min_tlen=30)
    _, grad = jax.jit(jax.value_and_grad(jax_ctc_loss))(lp, ll, tg, tl)
    x = torch.from_numpy(lp).requires_grad_()
    ctc_loss_kernel(x, torch.from_numpy(ll), torch.from_numpy(tg),
                    torch.from_numpy(tl)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=0,
                               atol=TOL)


def test_gradcheck_float64():
    """Finite differences of the float64 plain forward agree with the
    float64 plain backward (K3's plain version)."""
    lp, ll, tg, tl, _ = _case(np.random.default_rng(2), B=3, T=7, L=4, S=3,
                              min_tlen=6)
    x = torch.from_numpy(lp.astype(np.float64)).requires_grad_()
    args = (torch.from_numpy(ll), torch.from_numpy(tg), torch.from_numpy(tl))
    assert torch.autograd.gradcheck(
        lambda a: CTCLoss.apply(a, *args, 0), (x,), eps=1e-6, atol=1e-6)


def test_beta_reference_is_the_wrappers_cpu_path():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; stored alphas are the plain recursion's."""
    lp, ll, tg, tl, _ = _case(np.random.default_rng(3), T=20, S=4)
    t = [torch.from_numpy(a) for a in (lp, ll, tg, tl)]
    before = (ctc_alpha.launches, ctc_beta.launches)
    nll, alphas = ctc_alpha(*t, store_alphas=True)
    final, every = ctc_forward_alphas(*t, return_all=True)
    assert torch.equal(every, alphas) and torch.equal(every[:, -1], final)
    g = torch.linspace(0.5, 1.5, len(ll))
    ref = ctc_beta_reference(t[0], alphas, nll, t[1], t[2], t[3], g)
    assert torch.equal(ctc_beta(t[0], alphas, nll, t[1], t[2], t[3], g), ref)
    assert (ctc_alpha.launches, ctc_beta.launches) == before
