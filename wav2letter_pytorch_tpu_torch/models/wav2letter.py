"""Wav2Letter: a 1-D convolutional CTC acoustic model (PyTorch).

Same model as ``wav2letter_pytorch_tpu.models.wav2letter``: ``mid_layers``
blocks of reflect-SAME padding (or zero SAME padding, ``padding_mode``)
-> Conv1d -> BatchNorm (torch momentum 0.9, eps 1e-3) -> dropout ->
clamp(0, 20), then a 1x1 conv head to the labels and log_softmax.
``out_lengths = input_lengths // prod(strides)``. With ``compute_dtype``
bfloat16 each conv (the head's too) runs in bf16 as flax's
``nn.Conv(dtype=bfloat16)``: input and weight rounded, a bf16 output,
the bias added in bf16; BatchNorm, dropout, clamp and log_softmax then
run in float32.

Train mode (``model.train()``) follows flax: BatchNorm normalises with the
biased batch variance and updates its running statistics as
``0.1 * old + 0.9 * batch`` with that same biased variance (torch's own
``BatchNorm1d`` would store the unbiased one); dropout keeps each
activation with probability ``1 - rate``, scales it by ``1 / (1 - rate)``,
and draws from the ``generator`` passed to ``forward`` (``rate == -1``
disables it). In eval mode both are as in torch.

Under tensor parallelism (``parallel.tp.shard_module``) a block whose
conv is sharded computes its rank's output channels from the whole
input, BatchNorm on them, and gathers the channels before dropout (the
mask of the model=1 run) and the clamp; the 29-label head stays whole on
every rank.

Under sequence parallelism (``parallel.sp``) ``forward`` takes
``seq_len``, the global length of the features of which ``x`` holds this
rank's range: each block computes its rank's range of its output from
the input frames it reads (``sp.conv_input``: neighbours' frames
fetched, SAME padding by index at the global edges only) with
an unpadded conv, then BN (statistics over every rank's frames), the
dropout mask of the whole sequence (this rank's range of it) and the
clamp on its range; the output is this rank's range of the log-probs
(``out_time(seq_len)`` frames in all).

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

from ..parallel import sp, tp
from .base import (FlaxBatchNorm1d, conv1d_bf16, dropout, hardtanh_0_20,
                   init_conv_, same_pad_amount)

PADDING_MODES = ('reflect', 'zeros')

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


class Conv1dBlock(nn.Module):
    """SAME conv block with BN, dropout and clamp, on [B, C, T]: padded
    by reflection or with zeros (``padding_mode``), the conv in float32
    or, with ``compute_dtype`` bfloat16, in bf16 (``conv1d_bf16``) with
    everything after it in float32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, dropout: float = -1.0,
                 use_bn: bool = True, use_activation: bool = True,
                 padding_mode: str = 'reflect',
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if padding_mode not in PADDING_MODES:
            raise ValueError(f'padding_mode must be one of {PADDING_MODES}, '
                             f'got {padding_mode!r}')
        self.kernel_size, self.stride, self.dilation = (kernel_size, stride,
                                                        dilation)
        self.dropout = dropout
        self.use_activation = use_activation
        self.padding_mode, self.compute_dtype = padding_mode, compute_dtype
        self.conv1 = nn.Conv1d(in_channels, out_channels, kernel_size,
                               stride=stride, dilation=dilation)
        self.batch_norm = (FlaxBatchNorm1d(out_channels, momentum=0.9,
                                           eps=1e-3) if use_bn else None)

    def out_time(self, t_in: int) -> int:
        """Output frames at ``t_in`` input frames (SAME: ceil(t_in /
        stride))."""
        return -(-int(t_in) // self.stride)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                seq_len: int | None = None) -> torch.Tensor:
        # tensor parallelism (parallel.tp): a sharded conv is column-
        # parallel, its Cout slice and BN on it, then the channels gathered
        sharded = tp.is_sharded(self.conv1.weight)
        if sharded:
            x = tp.copy_to_model(x)
        left, right = same_pad_amount(x.shape[-1] if seq_len is None
                                      else seq_len, self.kernel_size,
                                      self.stride, self.dilation)
        pad = 0
        if seq_len is not None:   # this rank's output range, padded by index
            x, _ = sp.conv_input(x, 2, seq_len, self.kernel_size,
                                 self.stride, self.dilation, left, right,
                                 self.padding_mode)
        elif self.padding_mode == 'zeros' and left == right:
            pad = left            # the conv's own zero padding
        elif left or right:
            x = F.pad(x, (left, right), mode='reflect'
                      if self.padding_mode == 'reflect' else 'constant')
        conv = self.conv1
        if self.compute_dtype is not None:
            # bf16 out; BN (or the head's log_softmax) takes it in float32
            x = conv1d_bf16(x, conv.weight, conv.bias, self.stride, pad,
                            self.dilation).float()
        elif pad:
            x = F.conv1d(x, conv.weight, conv.bias, self.stride, pad,
                         self.dilation)
        else:
            x = conv(x)
        if self.batch_norm is not None:
            x = self.batch_norm(x)
        if sharded:
            x = tp.gather_from_model(x, 1)
        if self.training and self.dropout != -1 and self.dropout > 0:
            x = dropout(x, self.dropout, generator, 2,
                        None if seq_len is None else self.out_time(seq_len))
        if self.use_activation:
            x = hardtanh_0_20(x)
        return x


class Wav2Letter(nn.Module):
    """Wav2Letter conv stack -> log_softmax over labels.

    ``layers`` is the full layer spec, truncated to ``mid_layers`` blocks
    before the 1x1 head. With a ``generator``, conv weights are drawn from
    it by ``init_mode`` (the JAX package's ``model.init_mode``, default
    xavier-uniform) and biases start at zero; the module is built on the
    CPU and then moved to ``device``. ``padding_mode`` and
    ``compute_dtype`` (None: float32; ``torch.bfloat16``) are the JAX
    package's ``model.padding_mode`` and ``model.compute_dtype``; the
    parameters are float32 either way.
    """

    def __init__(self, num_labels: int, input_size: int = 64,
                 layers=WAV2LETTER_LAYERS, mid_layers: int = 20,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = 'cpu',
                 init_mode: str = 'xavier_uniform',
                 padding_mode: str = 'reflect',
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.padding_mode, self.compute_dtype = padding_mode, compute_dtype
        specs = list(layers)[:mid_layers]
        blocks = []
        cin = input_size
        for i, spec in enumerate(specs):
            blocks.append((f'conv1d_{i}', Conv1dBlock(
                cin, int(spec['output_size']), int(spec['kernel_size']),
                stride=int(spec.get('stride', 1)),
                dilation=int(spec.get('dilation', 1)),
                dropout=float(spec.get('dropout', -1.0)),
                padding_mode=padding_mode, compute_dtype=compute_dtype)))
            cin = int(spec['output_size'])
        blocks.append((f'conv1d_{len(specs)}', Conv1dBlock(
            cin, num_labels, 1, use_bn=False, use_activation=False,
            compute_dtype=compute_dtype)))
        self.conv1ds = nn.Sequential(OrderedDict(blocks))
        self.scaling_factor = 1
        for spec in specs:
            self.scaling_factor *= int(spec.get('stride', 1))
        if generator is not None:
            for block in self.conv1ds:
                init_conv_(block.conv1.weight, init_mode, generator)
                nn.init.zeros_(block.conv1.bias)
        self.to(device)

    def out_time(self, t_in: int) -> int:
        """Output frames at ``t_in`` feature frames."""
        for block in self.conv1ds:
            t_in = block.out_time(t_in)
        return t_in

    def forward(self, x: torch.Tensor, input_lengths=None,
                generator: torch.Generator | None = None,
                seq_len: int | None = None):
        """x: [B, T, F] features. Returns (log_probs [B, T', L],
        out_lengths [B] int32 or None). ``generator`` feeds dropout in
        train mode. With ``seq_len`` (sequence parallelism), ``x`` is this
        rank's range of ``seq_len`` frames and so is ``log_probs`` of
        ``out_time(seq_len)``; the lengths stay global."""
        y = x.transpose(1, 2)
        for block in self.conv1ds:
            y = block(y, generator, seq_len)
            if seq_len is not None:
                seq_len = block.out_time(seq_len)
        log_probs = F.log_softmax(y.transpose(1, 2).contiguous(), dim=-1)
        if input_lengths is None:
            return log_probs, None
        return log_probs, input_lengths.to(torch.int32) // self.scaling_factor
