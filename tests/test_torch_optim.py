"""The port's optimizers, schedules, clipping and accumulation vs the JAX
package (optax) and the NovoGrad numpy oracle of ``tests/test_optim.py``.

Each optimizer sees the same seeded numpy gradients on both sides; the
port's are torch optimizers stepped with ``.grad`` set by hand.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from wav2letter_pytorch_tpu import optim as jax_optim
from wav2letter_pytorch_tpu_torch import optim
from wav2letter_pytorch_tpu_torch.training.trainer import clip_by_global_norm

torch.set_num_threads(1)

# float32 updates in another operation order: a few ulps of the parameter.
RTOL, ATOL = 1e-5, 1e-6


def _novograd_oracle_steps(p0, grads, lr, beta1, beta2, eps, wd,
                           grad_averaging, amsgrad):
    """Pure-numpy replay of the original NovoGrad update order (the oracle
    of tests/test_optim.py)."""
    p = p0.copy()
    m = np.zeros_like(p)
    v = vmax = 0.0
    out = []
    for g in grads:
        norm = float((g ** 2).sum())
        v = norm if v == 0 else beta2 * v + (1 - beta2) * norm
        if amsgrad:
            vmax = max(vmax, v)
            denom = np.sqrt(vmax) + eps
        else:
            denom = np.sqrt(v) + eps
        g = g / denom
        if wd:
            g = g + wd * p
        if grad_averaging:
            g = g * (1 - beta1)
        m = beta1 * m + g
        p = p - lr * m
        out.append(p.copy())
    return out


def _steps(opt, param, grads):
    out = []
    for g in grads:
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        out.append(param.detach().numpy().copy())
    return out


def _optax_steps(tx, p0, grads):
    params = {'w': jnp.asarray(p0)}
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update({'w': jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        out.append(np.asarray(params['w']))
    return out


def _data(seed, shape=(4, 3), n=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            [rng.standard_normal(shape).astype(np.float32) for _ in range(n)])


@pytest.mark.parametrize('wd,ga,ams', [(0.0, False, False),
                                       (0.01, False, False),
                                       (0.01, True, False),
                                       (0.0, False, True)])
def test_novograd_matches_oracle_and_jax(wd, ga, ams):
    p0, grads = _data(0)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.Novograd([param], 1e-2, betas=(0.95, 0.5), weight_decay=wd,
                         grad_averaging=ga, amsgrad=ams)
    ours = _steps(opt, param, grads)
    oracle = _novograd_oracle_steps(p0.astype(np.float64),
                                    [g.astype(np.float64) for g in grads],
                                    1e-2, 0.95, 0.5, 1e-8, wd, ga, ams)
    theirs = _optax_steps(jax_optim.novograd(1e-2, betas=(0.95, 0.5),
                                             weight_decay=wd,
                                             grad_averaging=ga, amsgrad=ams),
                          p0, grads)
    for a, b, c in zip(ours, oracle, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


def test_novograd_validates_hyperparams():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError):
        optim.Novograd(p, 1e-3, betas=(1.5, 0.0))
    with pytest.raises(ValueError):
        optim.Novograd(p, 1e-3, betas=(0.9, -0.1))


@pytest.mark.parametrize('momentum,nesterov,wd', [(0.9, True, 1e-2),
                                                  (0.9, False, 0.0),
                                                  (0.0, False, 1e-3)])
def test_sgd_matches_jax(momentum, nesterov, wd):
    """Coupled weight decay + (Nesterov) momentum, the default optimizer
    group (exp_lr_optimizer.yaml)."""
    p0, grads = _data(1, shape=(5,), n=4)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ours = _steps(torch.optim.SGD([param], lr=1e-2, momentum=momentum,
                                  nesterov=nesterov, weight_decay=wd),
                  param, grads)
    theirs = _optax_steps(jax_optim.sgd(1e-2, momentum=momentum,
                                        nesterov=nesterov, weight_decay=wd),
                          p0, grads)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_adamw_matches_jax():
    p0, grads = _data(2, n=6)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ours = _steps(torch.optim.AdamW([param], lr=3e-3, weight_decay=0.1),
                  param, grads)
    theirs = _optax_steps(jax_optim.adamw(3e-3, weight_decay=0.1), p0, grads)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_exponential_lr_matches_jax():
    ours = optim.exponential_lr(1e-3, 0.999, steps_per_epoch=10)
    theirs = jax_optim.exponential_lr(1e-3, 0.999, steps_per_epoch=10)
    for step in range(0, 5000, 7):
        assert ours(step) == pytest.approx(theirs(step), rel=1e-12)
    assert ours(9) == ours(0) and ours(10) == pytest.approx(1e-3 * 0.999)


@pytest.mark.parametrize('total', [100, 33, 7])
def test_one_cycle_lr_matches_optax(total):
    """The JAX package's one-cycle is optax's cosine_onecycle_schedule
    (cumulative-scale cosine pieces), not torch's OneCycleLR."""
    ours = optim.one_cycle_lr(1e-3, total_steps=total)
    theirs = jax_optim.one_cycle_lr(1e-3, total_steps=total)
    for step in range(-1, 2 * total + 3):
        # optax evaluates in float32: a few float32 ulps of values up to
        # max_lr (observed <= 1.2e-10 absolute, ~2e-6 relative)
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-5,
                                           abs=1e-6 * 1e-3)
    torch_sched = torch.optim.lr_scheduler.OneCycleLR(
        torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1e-3),
        max_lr=1e-3, total_steps=total)
    torch_lrs = []
    for _ in range(total):
        torch_lrs.append(torch_sched.get_last_lr()[0])
        torch_sched.optimizer.step()
        torch_sched.step()
    assert max(abs(ours(s) - torch_lrs[s]) for s in range(total)) > 1e-6


@pytest.mark.parametrize('max_norm', [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    theirs, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ours = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(ours, max_norm)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads))
    assert (norm > max_norm) == any(not np.array_equal(a.numpy(), g)
                                    for a, g in zip(ours, grads))


def test_accumulated_clipped_sgd_matches_optax_multisteps():
    """k micro-batches' mean gradient, clipped, then one SGD update: the
    JAX Trainer's MultiSteps(chain(clip_by_global_norm, sgd)). The port's
    trainer sums the micro-batch gradients in ``.grad`` and divides by k at
    the update (``Trainer._update``); this replays that arithmetic."""
    k, lr, clip = 3, 0.1, 0.8
    p0, grads = _data(4, shape=(6,), n=2 * k)
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(clip),
        jax_optim.sgd(lr, momentum=0.9, nesterov=True, weight_decay=1e-2)),
        every_k_schedule=k)
    theirs = _optax_steps(tx, p0, grads)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([param], lr=lr, momentum=0.9, nesterov=True,
                          weight_decay=1e-2)
    acc = None
    for i, g in enumerate(grads):
        g = torch.from_numpy(g.copy())
        acc = g if acc is None else acc + g
        if (i + 1) % k == 0:
            param.grad = acc / k
            clip_by_global_norm([param.grad], clip)
            opt.step()
            acc = None
        np.testing.assert_allclose(param.detach().numpy(), theirs[i],
                                   rtol=RTOL, atol=ATOL)
