"""Wav2Letter: a 1-D convolutional CTC acoustic model (PyTorch).

Same model as ``wav2letter_pytorch_tpu.models.wav2letter``: ``mid_layers``
blocks of reflect-SAME padding -> Conv1d -> BatchNorm (torch momentum 0.9,
eps 1e-3) -> dropout -> clamp(0, 20), then a 1x1 conv head to the labels
and log_softmax. ``out_lengths = input_lengths // prod(strides)``.

Train mode (``model.train()``) follows flax: BatchNorm normalises with the
biased batch variance and updates its running statistics as
``0.1 * old + 0.9 * batch`` with that same biased variance (torch's own
``BatchNorm1d`` would store the unbiased one); dropout keeps each
activation with probability ``1 - rate``, scales it by ``1 / (1 - rate)``,
and draws from the ``generator`` passed to ``forward`` (``rate == -1``
disables it). In eval mode both are as in torch.

The public layout is the JAX one, ``[B, T, F]`` in and ``[B, T', L]`` out;
inside, activations are ``[B, C, T]`` for ``F.conv1d``. Parameter keys are
the reference torch layout (``conv1ds.conv1d_{i}.conv1.*``,
``conv1ds.conv1d_{i}.batch_norm.*``, head ``conv1ds.conv1d_{mid}.conv1.*``),
which ``weights.state_dict_from_flax`` produces from a JAX checkpoint.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .base import hardtanh_0_20, same_pad_amount

# configs/model/wav2letter.yaml of the JAX package: the full 20-layer stack.
WAV2LETTER_LAYERS = (
    dict(output_size=256, kernel_size=11, stride=2, dilation=1, dropout=0.2),
    dict(output_size=256, kernel_size=11, stride=1, dilation=1, dropout=0.2),
    dict(output_size=256, kernel_size=11, stride=1, dilation=1, dropout=0.2),
    dict(output_size=256, kernel_size=11, stride=1, dilation=1, dropout=0.2),
    dict(output_size=384, kernel_size=13, stride=1, dilation=1, dropout=0.2),
    dict(output_size=384, kernel_size=13, stride=1, dilation=1, dropout=0.2),
    dict(output_size=384, kernel_size=13, stride=1, dilation=1, dropout=0.2),
    dict(output_size=512, kernel_size=17, stride=1, dilation=1, dropout=0.2),
    dict(output_size=512, kernel_size=17, stride=1, dilation=1, dropout=0.2),
    dict(output_size=512, kernel_size=17, stride=1, dilation=1, dropout=0.2),
    dict(output_size=640, kernel_size=21, stride=1, dilation=1, dropout=0.3),
    dict(output_size=640, kernel_size=21, stride=1, dilation=1, dropout=0.3),
    dict(output_size=640, kernel_size=21, stride=1, dilation=1, dropout=0.3),
    dict(output_size=768, kernel_size=25, stride=1, dilation=1, dropout=0.3),
    dict(output_size=768, kernel_size=25, stride=1, dilation=1, dropout=0.3),
    dict(output_size=768, kernel_size=25, stride=1, dilation=1, dropout=0.3),
    dict(output_size=896, kernel_size=29, stride=1, dilation=2, dropout=0.4),
    dict(output_size=896, kernel_size=29, stride=1, dilation=2, dropout=0.4),
    dict(output_size=896, kernel_size=29, stride=1, dilation=2, dropout=0.4),
    dict(output_size=1024, kernel_size=1, stride=1, dilation=1, dropout=0.4),
)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``BatchNorm1d`` (same parameters, buffers and state-dict keys) whose
    train-mode running statistics follow flax: the biased batch variance,
    the one it normalises with, goes into ``running_var``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
            # torch's momentum is the weight of the NEW batch statistics.
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept values by ``1 / (1 - rate)``; the mask is drawn from
    ``generator`` (torch's default generator when None)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Conv1dBlock(nn.Module):
    """Reflect-pad SAME conv block with BN, dropout and clamp, on
    [B, C, T]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, dropout: float = -1.0,
                 use_bn: bool = True, use_activation: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = (kernel_size, stride,
                                                        dilation)
        self.dropout = dropout
        self.use_activation = use_activation
        self.conv1 = nn.Conv1d(in_channels, out_channels, kernel_size,
                               stride=stride, dilation=dilation)
        self.batch_norm = (FlaxBatchNorm1d(out_channels, momentum=0.9,
                                           eps=1e-3) if use_bn else None)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        left, right = same_pad_amount(x.shape[-1], self.kernel_size,
                                      self.stride, self.dilation)
        if left or right:
            x = F.pad(x, (left, right), mode='reflect')
        x = self.conv1(x)
        if self.batch_norm is not None:
            x = self.batch_norm(x)
        if self.training and self.dropout != -1 and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        if self.use_activation:
            x = hardtanh_0_20(x)
        return x


class Wav2Letter(nn.Module):
    """Wav2Letter conv stack -> log_softmax over labels.

    ``layers`` is the full layer spec, truncated to ``mid_layers`` blocks
    before the 1x1 head. With a ``generator``, conv weights are drawn
    xavier-uniform from it and biases start at zero (the JAX package's
    default init); the module is built on the CPU and then moved to
    ``device``.
    """

    def __init__(self, num_labels: int, input_size: int = 64,
                 layers=WAV2LETTER_LAYERS, mid_layers: int = 20,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = 'cpu'):
        super().__init__()
        specs = list(layers)[:mid_layers]
        blocks = []
        cin = input_size
        for i, spec in enumerate(specs):
            blocks.append((f'conv1d_{i}', Conv1dBlock(
                cin, int(spec['output_size']), int(spec['kernel_size']),
                stride=int(spec.get('stride', 1)),
                dilation=int(spec.get('dilation', 1)),
                dropout=float(spec.get('dropout', -1.0)))))
            cin = int(spec['output_size'])
        blocks.append((f'conv1d_{len(specs)}', Conv1dBlock(
            cin, num_labels, 1, use_bn=False, use_activation=False)))
        self.conv1ds = nn.Sequential(OrderedDict(blocks))
        self.scaling_factor = 1
        for spec in specs:
            self.scaling_factor *= int(spec.get('stride', 1))
        if generator is not None:
            for block in self.conv1ds:
                nn.init.xavier_uniform_(block.conv1.weight,
                                        generator=generator)
                nn.init.zeros_(block.conv1.bias)
        self.to(device)

    def forward(self, x: torch.Tensor, input_lengths=None,
                generator: torch.Generator | None = None):
        """x: [B, T, F] features. Returns (log_probs [B, T', L],
        out_lengths [B] int32 or None). ``generator`` feeds dropout in
        train mode."""
        y = x.transpose(1, 2)
        for block in self.conv1ds:
            y = block(y, generator)
        log_probs = F.log_softmax(y.transpose(1, 2).contiguous(), dim=-1)
        if input_lengths is None:
            return log_probs, None
        return log_probs, input_lengths.to(torch.int32) // self.scaling_factor
