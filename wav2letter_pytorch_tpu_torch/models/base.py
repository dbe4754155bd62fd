"""Shared acoustic-model pieces: activations, padding arithmetic, weight
init, flax-style BatchNorm and dropout."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_gather, data_group, data_world, draw_rows


def hardtanh_0_20(x: torch.Tensor) -> torch.Tensor:
    """clamp(0, 20) activation."""
    return torch.clamp(x, 0.0, 20.0)


def same_pad_amount(t_in: int, kernel: int, stride: int,
                    dilation: int) -> tuple[int, int]:
    """SAME padding (left, right) for a 1-D conv over a length-``t_in``
    axis: ceil(t_in / stride) output frames, the odd sample on the right."""
    out_t = (t_in + stride - 1) // stride
    pad = max(0, (out_t - 1) * stride + (kernel - 1) * dilation + 1 - t_in)
    return pad // 2, pad - pad // 2


def compute_new_kernel_size(kernel_size: int, kernel_width: float) -> int:
    """Scale a kernel by ``kernel_width``, rounding even results up to odd
    (Jasper's kernel sizes: 32 becomes 33)."""
    new = max(int(kernel_size * kernel_width), 1)
    return new + 1 if new % 2 == 0 else new


def get_same_padding(kernel_size: int, stride: int, dilation: int) -> int:
    """Jasper's symmetric zero padding of a conv."""
    if stride > 1 and dilation > 1:
        raise ValueError('Only stride OR dilation may be greater than 1')
    if dilation > 1:
        return (dilation * kernel_size) // 2 - 1
    return kernel_size // 2


# jax.random.truncated_normal over [-2, 2] has this standard deviation;
# the JAX package's *_normal inits divide by it to keep their variance.
_TRUNC_STD = 0.87962566103423978
INIT_MODES = ('xavier_uniform', 'xavier_normal', 'kaiming_uniform',
              'kaiming_normal')


def init_conv_(weight: torch.Tensor, mode: str = 'xavier_uniform',
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Draw a conv weight ``[C_out, C_in / groups, K]`` in place from
    ``generator``, with the distribution of the JAX package's
    ``conv_initializer(mode)``: xavier (fan_avg, scale 1) or kaiming
    (fan_in, scale 2), uniform or normal; the normal ones are normals
    truncated at two standard deviations, as ``jax.nn.initializers``
    draws them. The numbers differ from JAX's (another generator)."""
    if mode not in INIT_MODES:
        raise ValueError(f'Unknown initialization mode: {mode}')
    fan_in = weight.shape[1] * weight.shape[2]
    fan_out = weight.shape[0] * weight.shape[2]
    with torch.no_grad():
        if mode == 'xavier_uniform':
            return nn.init.xavier_uniform_(weight, generator=generator)
        if mode == 'kaiming_uniform':
            return nn.init.kaiming_uniform_(weight, nonlinearity='relu',
                                            generator=generator)
        var = (1.0 / ((fan_in + fan_out) / 2) if mode == 'xavier_normal'
               else 2.0 / fan_in)
        std = math.sqrt(var) / _TRUNC_STD
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def global_batch_stats(x: torch.Tensor):
    """(mean, biased variance) per channel of ``x`` [B_r, C, T] over every
    replica's B_r x T, differentiably: each rank's (count, mean, M2) are
    gathered over the data group and combined with Chan's parallel
    formula (not E[x^2] - mean^2, which loses digits when |mean| >>
    std). Under tensor parallelism ``x`` is this rank's channel slice and
    the ranks of the data group hold the same slice."""
    count = torch.full((1,), float(x.shape[0] * x.shape[2]),
                       dtype=x.dtype, device=x.device)
    mean = x.mean(dim=(0, 2))
    m2 = ((x - mean[None, :, None]) ** 2).sum(dim=(0, 2))
    parts = all_gather(torch.cat([count, mean, m2]),
                       data_group())   # [W, 1 + 2C]
    C = x.shape[1]
    n = parts[:, :1].detach()
    means, m2s = parts[:, 1:C + 1], parts[:, C + 1:]
    total = n.sum()
    g_mean = (n * means).sum(0) / total
    g_m2 = m2s.sum(0) + (n * (means - g_mean) ** 2).sum(0)
    return g_mean, g_m2 / total


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``BatchNorm1d`` (same parameters, buffers and state-dict keys) whose
    train-mode running statistics follow flax: the biased batch variance,
    the one it normalises with, goes into ``running_var``. With
    ``freeze_stats`` set (``frozen_statistics``) they stay as they are.

    Under a process group of more than one replica, train mode
    normalises with the statistics of the global batch
    (``global_batch_stats``, over the data group), as the JAX package's
    global-batch step does: every replica then holds the same running
    statistics, those of one process on the whole batch. Under tensor
    parallelism the weight, bias and running statistics are this rank's
    channel slice (``parallel.tp``) and so is the input: BatchNorm is
    per channel, so the model ranks need no collective."""

    freeze_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if data_world() > 1:
            return self._cross_replica(x)
        if not self.freeze_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
                # torch's momentum is the weight of the NEW batch statistics.
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _cross_replica(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = global_batch_stats(x)
        if not self.freeze_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        y = (x - mean[None, :, None]) * torch.rsqrt(var + self.eps)[None, :,
                                                                   None]
        return y * self.weight[None, :, None] + self.bias[None, :, None]


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """The ``FlaxBatchNorm1d`` layers under ``module`` keep their running
    statistics (a checkpointed block's recomputation in the backward must
    not move them a second time)."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm1d)]
    for m in norms:
        m.freeze_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.freeze_stats = False


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``; the mask is drawn from
    ``generator`` (torch's default generator when None; a
    ``RowGenerator``'s draw is this rank's rows of the global batch's)."""
    keep = 1.0 - rate
    mask = draw_rows(torch.rand, x.shape, generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
