"""Shared acoustic-model pieces: activations, padding arithmetic, the
bfloat16 conv, weight init, flax-style BatchNorm and dropout."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import sp
from ..parallel.mesh import (all_reduce_sum, chan_combine, draw_rows,
                             replica_group, replica_world)


def hardtanh_0_20(x: torch.Tensor) -> torch.Tensor:
    """clamp(0, 20) activation."""
    return torch.clamp(x, 0.0, 20.0)


def same_pad_amount(t_in: int, kernel: int, stride: int,
                    dilation: int) -> tuple[int, int]:
    """SAME padding (left, right) for a 1-D conv over a length-``t_in``
    axis: ceil(t_in / stride) output frames, the odd sample on the right.
    Under sequence parallelism ``t_in`` is the global length."""
    out_t = (t_in + stride - 1) // stride
    pad = max(0, (out_t - 1) * stride + (kernel - 1) * dilation + 1 - t_in)
    return pad // 2, pad - pad // 2


def conv1d_bf16(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None, stride: int = 1,
                padding: int = 0, dilation: int = 1,
                groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(dtype=bfloat16)`` on [B, C, T]: x and the weight
    rounded to bfloat16, a bfloat16 conv summed in float32 (cuDNN on the
    card, ATen on the CPU) whose output is rounded to bfloat16, then the
    bias rounded to bfloat16 and added to it, a second rounding. Returns
    bfloat16; the parameters stay float32 and their gradients come back
    through the casts."""
    bf16 = torch.bfloat16
    y = F.conv1d(x.to(bf16), weight.to(bf16), None, stride, padding,
                 dilation, groups)
    if bias is not None:
        y = y + bias.to(bf16)[:, None]
    return y


def from_bf16(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 conv output as float32 (what follows a conv runs in
    float32); any other tensor as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


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


class CrossReplicaBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of ``x`` [B_r, C, T_r] with the statistics of
    every rank of ``group``'s B_r x T_r: each rank's (count, mean, M2)
    combined with Chan's formula (``chan_combine``; not E[x^2] - mean^2,
    which loses digits when |mean| >> std). Returns (y, mean, biased
    variance). Under tensor parallelism ``x`` is this rank's channel
    slice and the group's ranks hold the same slice; under sequence
    parallelism ``x`` is this rank's range of frames (the ranks' counts
    may differ).

    The backward is BatchNorm's closed form over the global batch: the
    per-channel sums of dy and dy * xhat are summed over the group and
    dx = w * invstd * (dy - mean(dy) - xhat * mean(dy * xhat)); the
    weight and bias get this rank's share (the trainer sums gradients
    over the group). So only the input and the statistics are kept for
    it: an autograd graph through the statistics would keep several
    activation-sized tensors a layer."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        n = torch.full_like(x[0, :, 0], float(x.shape[0] * x.shape[2]))
        mean = x.mean(dim=(0, 2))
        m2 = ((x - mean[None, :, None]) ** 2).sum(dim=(0, 2))
        total, mean, m2 = chan_combine(n, mean, m2, group)
        var = m2 / total
        invstd = torch.rsqrt(var + eps)
        ctx.group = group
        ctx.save_for_backward(x, weight, mean, invstd, total)
        ctx.mark_non_differentiable(mean, var)
        y = ((x - mean[None, :, None]) * (invstd * weight)[None, :, None]
             + bias[None, :, None])
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _, __):
        x, weight, mean, invstd, total = ctx.saved_tensors
        xhat = (x - mean[None, :, None]) * invstd[None, :, None]
        local = torch.stack([dy.sum(dim=(0, 2)),
                             (dy * xhat).sum(dim=(0, 2))])     # [2, C]
        sums = all_reduce_sum(local.clone(), ctx.group) / total
        dx = (weight * invstd)[None, :, None] * (
            dy - sums[0][None, :, None] - xhat * sums[1][None, :, None])
        return dx, local[1], local[0], None, None


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``BatchNorm1d`` (same parameters, buffers and state-dict keys) whose
    train-mode running statistics follow flax: the biased batch variance,
    the one it normalises with, goes into ``running_var``. With
    ``freeze_stats`` set (``frozen_statistics``) they stay as they are.

    Under a process group whose replica group has more than one rank
    (several replicas, or time slices of one), train mode normalises with
    the statistics of the global batch (``CrossReplicaBatchNorm``), as the
    JAX package's global-batch step does: every rank then holds the same
    running statistics, those of one process on the whole batch. Under
    tensor parallelism the weight, bias and running statistics are this
    rank's channel slice (``parallel.tp``) and so is the input: BatchNorm
    is per channel, so the model ranks need no collective."""

    freeze_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if replica_world() > 1:
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
        y, mean, var = CrossReplicaBatchNorm.apply(
            x, self.weight, self.bias, self.eps, replica_group())
        if not self.freeze_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
        return y


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
            generator: torch.Generator | None, time_dim: int = 1,
            seq_len: int | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``; the mask is drawn from
    ``generator`` (torch's default generator when None; a
    ``RowGenerator``'s draw is this rank's rows of the global batch's).
    With ``seq_len``, ``x`` is this rank's range of ``seq_len`` frames
    along ``time_dim`` (sequence parallelism): the mask is drawn for every
    frame and this rank keeps its range, the draws of one process."""
    keep = 1.0 - rate
    shape = list(x.shape)
    if seq_len is not None:
        shape[time_dim] = int(seq_len)
    mask = draw_rows(torch.rand, tuple(shape), generator,
                     device=x.device) < keep
    if seq_len is not None:
        lo, hi = sp.local_range(seq_len)
        mask = mask.narrow(time_dim, lo, hi - lo)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
