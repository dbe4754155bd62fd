"""K6 and K7's plain versions (``ops/sep_conv.py``) vs the JAX package's
fused separable-conv unit: the Pallas kernels in interpret mode and the
two-conv lax reference, forward (masks on and off, ragged lengths) and the
three gradients.

Geometries follow ``tests/test_sep_conv_pallas.py`` at small widths
(stride 1; odd and even K; dilation 2; Cin != Cout). Lengths are floats
with a .5, as C1 of QuartzNet leaves them, so the int casts of ``_masks``
are exercised. On the CPU ``sep_conv1d`` runs the plain K6 forward and the
plain K7 backward (the TPU kernel's arithmetic); autograd through the plain
forward is checked too. The card runs the kernels themselves against these
plain versions (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu.ops.sep_conv_pallas import _masks as jax_masks
from wav2letter_pytorch_tpu.ops.sep_conv_pallas import (sep_conv1d as
                                                        jax_sep,
                                                        sep_conv1d_xla)
from wav2letter_pytorch_tpu_torch.models.base import get_same_padding
from wav2letter_pytorch_tpu_torch.ops.sep_conv import (mask_lengths,
                                                       out_length, sep_bwd,
                                                       sep_conv1d, sep_fwd,
                                                       sep_fwd_reference)

torch.set_num_threads(1)

# (B, T, Cin, Cout, K, dilation)
GEOMETRIES = [
    (2, 50, 16, 16, 33, 1),
    (2, 50, 16, 32, 32, 1),     # even K: T_out = T + 1; Cin != Cout
    (1, 60, 32, 16, 13, 2),     # C2-style dilation
    (2, 40, 8, 16, 11, 1),
]
# float32: K depthwise taps then a Cin-term product, summed in other orders.
FWD_TOL = 1e-5
# Gradients sum B*T_out products (weights) or Cout + K terms (dx).
GRAD_TOL = 1e-4


def _inputs(B, T, Cin, Cout, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    wdw = (rng.standard_normal((K, Cin)) * 0.1).astype(np.float32)
    wpw = (rng.standard_normal((Cin, Cout)) * 0.2).astype(np.float32)
    lens = (rng.integers(T // 2, T, size=B) + 0.5).astype(np.float32)
    return x, wdw, wpw, lens, rng


@pytest.mark.parametrize('use_mask', [True, False])
@pytest.mark.parametrize('B,T,Cin,Cout,K,d', GEOMETRIES)
def test_forward_matches_jax(B, T, Cin, Cout, K, d, use_mask):
    x, wdw, wpw, lens, _ = _inputs(B, T, Cin, Cout, K, 0)
    p = get_same_padding(K, 1, d)
    ours = sep_conv1d(torch.from_numpy(x), torch.from_numpy(lens),
                      torch.from_numpy(wdw), torch.from_numpy(wpw), d, p,
                      use_mask=use_mask)
    assert ours.shape == (B, out_length(T, K, d, p), Cout)
    args = (jnp.asarray(x), jnp.asarray(lens), jnp.asarray(wdw),
            jnp.asarray(wpw), d, p, use_mask)
    for ref in (sep_conv1d_xla(*args), jax_sep(*args, interpret=True)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize('B,T,Cin,Cout,K,d', GEOMETRIES)
def test_gradients_match_jax(B, T, Cin, Cout, K, d):
    x, wdw, wpw, lens, rng = _inputs(B, T, Cin, Cout, K, 1)
    p = get_same_padding(K, 1, d)
    g = rng.standard_normal((B, out_length(T, K, d, p), Cout)).astype(
        np.float32)
    jl = jnp.asarray(lens)

    def jax_grads(fn):
        return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * jnp.asarray(g)),
                        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wdw),
                                           jnp.asarray(wpw))
    refs = [jax_grads(lambda a, b, c: sep_conv1d_xla(a, jl, b, c, d, p)),
            jax_grads(lambda a, b, c: jax_sep(a, jl, b, c, d, p,
                                              interpret=True))]
    len1, len2 = mask_lengths(torch.from_numpy(lens), K, d, p)

    def torch_grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, wdw, wpw)]
        (fn(*ts) * torch.from_numpy(g)).sum().backward()
        return [t.grad for t in ts]
    ours = [torch_grads(lambda a, b, c: sep_conv1d(
                a, torch.from_numpy(lens), b, c, d, p)),
            torch_grads(lambda a, b, c: sep_fwd_reference(
                a, len1, len2, b, c, d, p))]
    for got in ours:
        for ref in refs:
            for name, gv, rv in zip(('dx', 'dwdw', 'dwpw'), got, ref):
                np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=0,
                                           atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize('K,d', [(33, 1), (32, 1), (87, 2)])
def test_mask_lengths_match_jax_masks(K, d):
    T = 120
    p = get_same_padding(K, 1, d)
    t_out = out_length(T, K, d, p)
    lens = np.array([120.0, 404.5 - 300, 61.5, 7.0], np.float32)
    m1, m2 = jax_masks(jnp.asarray(lens), T, t_out, K, d, p)
    len1, len2 = mask_lengths(torch.from_numpy(lens), K, d, p)
    assert len1.dtype == len2.dtype == torch.int32
    np.testing.assert_array_equal(
        (np.arange(T)[None, :] < len1.numpy()[:, None]), np.asarray(m1)[..., 0])
    np.testing.assert_array_equal(
        (np.arange(t_out)[None, :] < len2.numpy()[:, None]),
        np.asarray(m2)[..., 0])


def test_lengths_get_no_gradient_and_cpu_launches_nothing():
    x, wdw, wpw, lens, _ = _inputs(2, 30, 8, 8, 5, 3)
    lt = torch.from_numpy(lens).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    sep_fwd.launches = sep_bwd.launches = 0
    sep_conv1d(xt, lt, torch.from_numpy(wdw), torch.from_numpy(wpw), 1,
               2).sum().backward()
    assert lt.grad is None and xt.grad is not None
    assert sep_fwd.launches == 0 and sep_bwd.launches == 0
    with pytest.raises(ValueError, match='unsupported device'):
        sep_fwd(torch.zeros(1, 10, 4, device='meta'), None, None,
                torch.zeros(3, 4, device='meta'),
                torch.zeros(4, 4, device='meta'))


def test_k6_phase_split_guards_fit_the_kernel_source():
    """tools/k6_phase_split.py switches K6's phases off by inserting guards
    at fixed places of csrc/sep_conv.cu; each place must be there once."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools', 'k6_phase_split.py')
    spec = importlib.util.spec_from_file_location('k6_phase_split', path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.guarded_source()
    for macro in tool.GUARDS:
        assert f'{macro}\n' in src
    assert set(m for ms in tool.VARIANTS.values() for m in ms) == set(
        tool.GUARDS)
