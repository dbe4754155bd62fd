"""K4 and K5's plain versions (``ops/depthwise.py``) vs the JAX package's
depthwise conv: the Pallas kernels in interpret mode and the lax grouped
conv at precision 'highest', forward and both gradients.

Geometries follow ``tests/test_depthwise_pallas.py`` at small widths: odd
and even K, stride 1 and 2 (with the stride-flooring tail), dilation 1 and
2. On the CPU ``depthwise_conv1d`` runs the plain K4 for the forward and
for the input gradient (the zero-stuffed, flipped-kernel conv of
``_dw_op_bwd``) and the plain K5 for the weight gradient; autograd through
the plain forward is checked too. The card runs the kernels themselves
against these plain versions (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.models.jasper import \
    get_same_padding as jax_same_padding
from wav2letter_pytorch_tpu.ops.depthwise_pallas import (depthwise_conv1d
                                                         as jax_dw,
                                                         depthwise_conv1d_xla)
from wav2letter_pytorch_tpu_torch.models.base import get_same_padding
from wav2letter_pytorch_tpu_torch.ops.depthwise import (
    depthwise_conv1d, depthwise_fwd, depthwise_fwd_reference,
    depthwise_wgrad, out_length)

torch.set_num_threads(1)

# (B, T, C, K, stride, dilation)
GEOMETRIES = [
    (2, 50, 16, 33, 1, 1),    # QuartzNet B-block kernel
    (2, 50, 16, 32, 1, 1),    # even K: T_out = T + 1
    (2, 51, 8, 33, 2, 1),     # C1: stride 2, odd T
    (2, 40, 16, 7, 2, 1),     # even T with stride: the flooring tail
    (1, 60, 8, 13, 1, 2),     # C2-style dilation 2
]
# float32 K-tap sums (K <= 33 terms of O(1)) in other orders: ~1e-6.
FWD_TOL = 1e-5
# The weight gradient sums B*T products of O(1): ~1e-5 of rounding.
GRAD_TOL = 1e-4


def _inputs(B, T, C, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) * 0.1).astype(np.float32)
    return x, w, rng


@pytest.mark.parametrize('B,T,C,K,s,d', GEOMETRIES)
def test_forward_matches_jax(B, T, C, K, s, d):
    x, w, _ = _inputs(B, T, C, K, 0)
    p = get_same_padding(K, s, d)
    assert p == jax_same_padding(K, s, d)
    ours = depthwise_fwd(torch.from_numpy(x), torch.from_numpy(w), s, d, p)
    assert ours.shape == (B, out_length(T, K, s, d, p), C)
    xla = depthwise_conv1d_xla(jnp.asarray(x), jnp.asarray(w), s, d, p,
                               precision='highest')
    pallas = jax_dw(jnp.asarray(x), jnp.asarray(w), s, d, p, interpret=True)
    for ref in (xla, pallas):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=FWD_TOL)


@pytest.mark.parametrize('B,T,C,K,s,d', GEOMETRIES)
def test_gradients_match_jax(B, T, C, K, s, d):
    x, w, rng = _inputs(B, T, C, K, 1)
    p = get_same_padding(K, s, d)
    t_out = out_length(T, K, s, d, p)
    g = rng.standard_normal((B, t_out, C)).astype(np.float32)

    def jax_grads(fn):
        return jax.grad(lambda a, b: jnp.sum(fn(a, b) * jnp.asarray(g)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    refs = [jax_grads(lambda a, b: depthwise_conv1d_xla(
                a, b, s, d, p, precision='highest')),
            jax_grads(lambda a, b: jax_dw(a, b, s, d, p, interpret=True))]

    def torch_grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        (fn(xt, wt) * torch.from_numpy(g)).sum().backward()
        return xt.grad, wt.grad
    ours = [torch_grads(lambda a, b: depthwise_conv1d(a, b, s, d, p)),
            torch_grads(lambda a, b: depthwise_fwd_reference(a, b, s, d, p))]
    for gx, gw in ours:
        for rx, rw in refs:
            np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=0,
                                       atol=GRAD_TOL)
            np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=0,
                                       atol=GRAD_TOL)
    # K5 alone is the weight gradient of the cotangent g
    dw = depthwise_wgrad(torch.from_numpy(x), torch.from_numpy(g), K, s, d, p)
    np.testing.assert_allclose(dw.numpy(), np.asarray(refs[0][1]), rtol=0,
                               atol=GRAD_TOL)


def test_cpu_wrappers_launch_nothing_and_refuse_other_devices():
    x = torch.zeros(1, 10, 4)
    w = torch.zeros(3, 4)
    depthwise_fwd.launches = depthwise_wgrad.launches = 0
    depthwise_conv1d(x.requires_grad_(), w, 1, 1, 1).sum().backward()
    assert depthwise_fwd.launches == 0 and depthwise_wgrad.launches == 0
    with pytest.raises(ValueError, match='unsupported device'):
        depthwise_fwd(torch.zeros(1, 10, 4, device='meta'),
                      torch.zeros(3, 4, device='meta'))
