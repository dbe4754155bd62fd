"""Jasper / QuartzNet: BxR residual (separable) conv CTC acoustic models.

Same model as ``wav2letter_pytorch_tpu.models.jasper``:

* ``MaskedConv`` zero-fills frames past each sample's length before its
  conv and carries the lengths as floats through the conv arithmetic with
  true division (C1 of QuartzNet turns 808 frames into 404.5); they are
  cast to int only for masks and at the head;
* ``JasperBlock``: ``repeat`` x (conv -> norm [batch | group | instance |
  layer] -> GroupShuffle when ``groups > 1`` -> act -> dropout, the last
  repeat without act and dropout), 1x1-conv residual branches (one per
  dense pane) joined by ``add`` or ``max``, then act and dropout;
  separable convs are depthwise + pointwise; ``heads`` folds a depthwise
  conv's channel blocks into the batch;
* ``Jasper``: the blocks, a 1x1 head with bias, ``log_softmax`` in train
  mode and ``softmax`` in eval mode (``eval_emits_probs``).

Kernels, where the JAX package takes its Pallas branches with
``W2L_SEPCONV=pallas`` and ``W2L_DEPTHWISE=pallas`` (the port has no
switch; on the card the kernels are the path):

* a main-chain separable unit with kernel > 1, stride 1, no heads and
  groups 1 runs as one fused unit, ``ops.sep_conv.sep_conv1d`` (K6 forward,
  K7 backward);
* any other depthwise ``MaskedConv`` (kernel > 1, no heads, no bias,
  groups == features == channels; QuartzNet's stride-2 C1) runs
  ``ops.depthwise.depthwise_conv1d`` (K4 forward, K4 + K5 backward);
* the rest is ``F.conv1d``, what JAX leaves to XLA: 1x1 pointwise and
  residual convs, heads-folded and grouped convs, C3 and the head.

With ``compute_dtype`` bfloat16 (the JAX package's ``dtype=bfloat16``)
the convs round through bf16 where flax's do: a ``MaskedConv`` masks
first, then its conv takes x and the weight in bf16 and gives bf16 (K4
in bf16, or ``conv1d_bf16``), cast to float32 before the norm; the fused
unit (K6/K7) reads bf16 x only, its weights, intermediate and output
float32, and its dx comes back bf16; K4's weight gradient is rounded to
bf16 as JAX's ``dw.astype(w.dtype)``; the head is a bf16 conv with a
bf16 bias, cast to float32 before the softmax. Norms, residuals,
activations and dropout run in float32.

Train mode follows flax: BatchNorm (torch momentum 0.1, eps 1e-3) keeps
the biased batch variance (``FlaxBatchNorm1d``); dropout draws from the
``generator`` passed to ``forward``; ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``), replaying its dropout draws and
leaving BatchNorm statistics alone, so gradients are bit-identical.

Under tensor parallelism (``parallel.tp.shard_module``) every sharded
conv gives its rank's output channels: a 1x1 or grouped conv column-
parallel from the whole input (``MaskedConv._column``), a depthwise conv
through K4 on the input's channel slice, the fused unit through K6/K7 on
the whole input, the gathered depthwise weight and the rank's pointwise
columns; each norm runs on the slice and the channels are gathered
after it, before GroupShuffle, the residual add, act and dropout (the
model=1 draws). Remat re-runs the gathers, in the same order on every
rank.

Under sequence parallelism (``parallel.sp``) ``forward`` takes
``seq_len``, the global length of the features of which ``x`` holds
this rank's range. Masks compare global frame indices with the lengths,
which stay global; a conv that reads other frames (kernel > 1 or a
stride) computes this rank's range of its output from the input frames
it reads (``sp.conv_input``, zeros outside the sequence) with padding 0:
K4 / K5 for a depthwise conv (QuartzNet's strided C1), K6 / K7 for the
fused unit with ``len1`` / ``len2`` shifted to the haloed input's and the
output's first global frame, ``F.conv1d`` otherwise. 1x1 convs (the
residual branches among them), act, GroupShuffle and the dropout masks
(drawn for every frame, this rank's range kept) run on the rank's
range; BatchNorm takes its statistics over every rank's frames
(``FlaxBatchNorm1d``) and group, instance and layer norm theirs
(``tp.group_norm``). The output is this rank's range of
``out_time(seq_len)`` frames; the lengths stay global.

Layout ``[B, T, C]`` throughout, as in JAX. Parameter keys are the
reference torch layout: ``jasper_encoder.{b}.mconv.{i}.conv.weight``, the
norm at its ``mconv`` index, parameter-less slots for act + dropout after
every non-last repeat and for GroupShuffle, ``jasper_encoder.{b}.res.{j}.
{0,1}``, and ``final_layer.0``; ``weights.state_dict_from_flax`` produces
it from a JAX checkpoint.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.depthwise import depthwise_conv1d
from ..ops.sep_conv import sep_conv1d
from ..parallel import sp, tp
from .base import (FlaxBatchNorm1d, compute_new_kernel_size, conv1d_bf16,
                   dropout, from_bf16, frozen_statistics, get_same_padding,
                   hardtanh_0_20, init_conv_)

_ACTIVATIONS = {
    'relu': F.relu,
    'hardtanh': hardtanh_0_20,
    'selu': F.selu,
}
NORMALIZATIONS = ('batch', 'group', 'instance', 'layer')


def group_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave channels across groups. x: [B, T, C], C = groups * cpg."""
    B, T, C = x.shape
    return x.reshape(B, T, groups, C // groups).transpose(2, 3).reshape(
        B, T, C)


class Activation(nn.Module):
    """relu, hardtanh (clamp 0, 20) or selu; a module so that a hook can see
    (and a check can force) its branches."""

    def __init__(self, name: str):
        super().__init__()
        if name not in _ACTIVATIONS:
            raise ValueError(f'Unknown activation {name!r}; expected one of '
                             f'{sorted(_ACTIVATIONS)}')
        self.name = name

    def forward(self, x):
        return _ACTIVATIONS[self.name](x)


class Dropout(nn.Module):
    """flax ``nn.Dropout`` (see ``base.dropout``); identity in eval mode and
    at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: torch.Generator | None = None,
                seq_len: int | None = None):
        if not self.training or self.rate == 0.0:
            return x
        return dropout(x, self.rate, generator, 1, seq_len)


class GroupShuffle(nn.Module):
    def __init__(self, groups: int):
        super().__init__()
        self.groups = groups

    def forward(self, x):
        return group_shuffle(x, self.groups)


def make_norm(kind: str, channels: int, norm_groups: int) -> nn.Module:
    """The block's norm over ``channels``; applied to [B, C, T]."""
    if kind == 'batch':
        # torch momentum 0.1 is flax momentum 0.9.
        return FlaxBatchNorm1d(channels, momentum=0.1, eps=1e-3)
    ng = channels if norm_groups == -1 else norm_groups
    if kind == 'group':
        return nn.GroupNorm(ng, channels, eps=1e-5)
    if kind == 'instance':
        return nn.GroupNorm(channels, channels, eps=1e-5)
    if kind == 'layer':
        return nn.GroupNorm(1, channels, eps=1e-5)
    raise ValueError(f'Normalization method ({kind}) does not match one of '
                     f'{list(NORMALIZATIONS)}.')


def apply_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``norm`` on [B, T, C] (this rank's channel slice when its
    parameters are sharded: ``tp.group_norm`` combines the statistics of
    a group that straddles the shards)."""
    y = x.transpose(1, 2)
    y = tp.group_norm(y, norm) if isinstance(norm, nn.GroupNorm) else norm(y)
    return y.transpose(1, 2)


def norm_gathered(norm: nn.Module, x: torch.Tensor,
                  sliced: bool) -> torch.Tensor:
    """``norm`` on ``x`` [B, T, C], whose channels are this rank's slice
    when ``sliced``, with the whole channels out: the norm runs on the
    slice where its parameters are sharded (a whole ``x`` is cut to it),
    then the slices are gathered (``tp.gather_from_model``)."""
    norm_sharded = tp.is_sharded(norm.weight)
    if sliced and not norm_sharded:
        x, sliced = tp.gather_from_model(x, 2), False
    elif norm_sharded and not sliced:
        x, sliced = tp.scatter_to_model(x, 2), True
    x = apply_norm(norm, x)
    return tp.gather_from_model(x, 2) if sliced else x


class MaskedConv(nn.Module):
    """1-D conv on [B, T, C] that zero-fills frames past each sample's
    length first and returns the new float lengths. ``heads`` folds a
    depthwise conv over C channels into one over ``heads`` channels with
    C / heads folded into the batch."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 heads: int = -1, padding: int = 0, use_bias: bool = False,
                 use_mask: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.in_channels, self.features = in_channels, features
        self.compute_dtype = compute_dtype
        self.kernel_size, self.stride, self.dilation = (kernel_size, stride,
                                                        dilation)
        self.groups, self.heads, self.padding = groups, heads, padding
        self.use_mask = use_mask
        if heads != -1:
            self.conv = nn.Conv1d(heads, heads, kernel_size, stride=stride,
                                  dilation=dilation, groups=heads,
                                  bias=use_bias)
        else:
            self.conv = nn.Conv1d(in_channels, features, kernel_size,
                                  stride=stride, dilation=dilation,
                                  groups=groups, bias=use_bias)
        # K4 takes a depthwise conv (the JAX package's Pallas condition).
        self.uses_kernel = (kernel_size > 1 and heads == -1 and not use_bias
                            and groups == features == in_channels)

    @property
    def out_sharded(self) -> bool:
        """Whether ``forward`` returns this rank's slice of the output
        channels (the weight is sharded, ``parallel.tp``): a depthwise
        conv then runs on the input's slice, any other conv is column-
        parallel. A heads-folded conv gathers its weight and returns the
        whole output."""
        return self.heads == -1 and tp.is_sharded(self.conv.weight)

    def _column(self, x: torch.Tensor, padding: int) -> torch.Tensor:
        """This rank's output channels of the (grouped) conv from the whole
        input ``x`` [B, T, C]: one conv over the groups the slice covers
        whole, else one conv a group it touches, on that group's input
        channels. With ``compute_dtype`` bfloat16 each is ``conv1d_bf16``
        and the columns are bfloat16, the one-process conv's columns."""
        sl = tp.shard_slice(self.conv.weight)
        opg = self.features // self.groups
        ipg = self.in_channels // self.groups
        pieces, start = [], sl.start
        while start < sl.stop:
            g = start // opg
            stop = min(sl.stop, (g + 1) * opg)
            pieces.append((g, start - sl.start, stop - sl.start))
            start = stop
        xt = x.transpose(1, 2)
        w, b = self.conv.weight, self.conv.bias
        geometry = (self.stride, padding, self.dilation)
        conv = F.conv1d if self.compute_dtype is None else conv1d_bf16
        if len(pieces) > 1 and all(hi - lo == opg for _, lo, hi in pieces):
            g0 = pieces[0][0]
            y = conv(xt[:, g0 * ipg:(g0 + len(pieces)) * ipg], w, b,
                     *geometry, len(pieces))
        else:
            y = torch.cat([conv(
                xt[:, g * ipg:(g + 1) * ipg], w[lo:hi],
                None if b is None else b[lo:hi], *geometry, 1)
                for g, lo, hi in pieces], 1)
        return y.transpose(1, 2)

    def out_length(self, lens: torch.Tensor) -> torch.Tensor:
        return (lens + 2 * self.padding
                - self.dilation * (self.kernel_size - 1) - 1) / self.stride + 1

    def out_time(self, t_in: int) -> int:
        """Output frames at ``t_in`` input frames."""
        span = self.dilation * (self.kernel_size - 1) + 1
        return (int(t_in) + 2 * self.padding - span) // self.stride + 1

    def forward(self, x: torch.Tensor, lens, seq_len: int | None = None):
        """(y, new lengths); with ``seq_len``, ``x`` and ``y`` are this
        rank's ranges of ``seq_len`` and ``out_time(seq_len)`` frames.
        With ``compute_dtype`` bfloat16, ``y`` is bfloat16: x and the
        weight rounded, the conv (K4 or ``conv1d_bf16``) summed in
        float32 and its output rounded."""
        if self.use_mask and lens is not None:
            T = x.shape[1]
            start = 0 if seq_len is None else sp.local_range(seq_len)[0]
            mask = (torch.arange(start, start + T, device=x.device)[None, :]
                    < lens.to(torch.int32)[:, None])
            x = x * mask[:, :, None].to(x.dtype)
            lens = self.out_length(lens)
        pad = self.padding
        if seq_len is not None and (self.kernel_size > 1 or self.stride > 1
                                    or pad):
            x, _ = sp.conv_input(x, 1, seq_len, self.kernel_size,
                                 self.stride, self.dilation, pad, pad)
            pad = 0
        bf16 = self.compute_dtype
        if self.uses_kernel:
            w = self.conv.weight[:, 0, :].t().contiguous()      # [K, C]
            if self.out_sharded:   # K4 on this rank's channels
                x = tp.scatter_to_model(x, 2)
            if bf16 is not None:   # K4 in bf16 (dw rounded to bf16 too)
                x, w = x.to(bf16), w.to(bf16)
            return depthwise_conv1d(x.contiguous(), w, self.stride,
                                    self.dilation, pad), lens
        if self.out_sharded:
            return self._column(tp.copy_to_model(x), pad), lens
        B, T, C = x.shape
        groups, weight = self.groups, self.conv.weight
        if self.heads != -1:
            # [B, T, C] -> [B * C/heads, T, heads]
            x = x.reshape(B, T, C // self.heads, self.heads).transpose(1, 2)
            x = x.reshape(-1, T, self.heads)
            groups = self.heads
            # replicated on every model rank, from the whole weight
            weight = tp.whole_param(weight, partial=False)
        conv = F.conv1d if bf16 is None else conv1d_bf16
        y = conv(x.transpose(1, 2), weight, self.conv.bias, self.stride, pad,
                 self.dilation, groups).transpose(1, 2)
        if self.heads != -1:
            T2 = y.shape[1]
            y = y.reshape(B, self.features // self.heads, T2, self.heads)
            y = y.transpose(1, 2).reshape(B, T2, self.features)
        return y, lens


class JasperBlock(nn.Module):
    """One BxR block. ``forward`` takes the residual-pane inputs (the last
    is the block's main input) and returns ``(out, lens)``.
    ``res_channels`` are the panes' widths (one residual branch each)."""

    def __init__(self, in_channels: int, planes: int, repeat: int = 3,
                 kernel_size: int = 11, kernel_size_factor: float = 1.0,
                 stride: int = 1, dilation: int = 1, dropout: float = 0.2,
                 activation: str = 'hardtanh', residual: bool = True,
                 groups: int = 1, separable: bool = False, heads: int = -1,
                 normalization: str = 'batch', norm_groups: int = 1,
                 residual_mode: str = 'add', dense_residual: bool = False,
                 conv_mask: bool = False, res_channels=None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        bf16 = dict(compute_dtype=compute_dtype)
        if residual_mode not in ('add', 'max'):
            raise ValueError(f'residual_mode must be add or max, got '
                             f'{residual_mode!r}')
        kernel = compute_new_kernel_size(kernel_size, float(kernel_size_factor))
        pad = get_same_padding(kernel, stride, dilation)
        self.kernel, self.stride, self.dilation, self.pad = (kernel, stride,
                                                             dilation, pad)
        self.conv_mask = conv_mask
        self.residual = residual
        self.residual_mode = residual_mode
        self.dense_residual = dense_residual
        # Fused separable unit (K6/K7): the JAX package's Pallas condition.
        self.fused = (separable and kernel > 1 and stride == 1
                      and heads == -1 and groups == 1)
        mconv, self.layout = [], []
        cin = in_channels
        for r in range(repeat):
            convs = []
            if separable and kernel > 1:
                convs.append(MaskedConv(cin, cin, kernel, stride, dilation,
                                        groups=cin, heads=heads, padding=pad,
                                        use_mask=conv_mask, **bf16))
                convs.append(MaskedConv(cin, planes, 1, groups=groups,
                                        use_mask=conv_mask, **bf16))
            else:
                convs.append(MaskedConv(cin, planes, kernel, stride, dilation,
                                        groups=groups, heads=heads,
                                        padding=pad, use_mask=conv_mask,
                                        **bf16))
            slots = {'convs': list(range(len(mconv), len(mconv) + len(convs)))}
            mconv += convs
            slots['norm'] = len(mconv)
            mconv.append(make_norm(normalization, planes, norm_groups))
            if groups > 1:
                slots['shuffle'] = len(mconv)
                mconv.append(GroupShuffle(groups))
            if r < repeat - 1:
                slots['act'] = len(mconv)
                mconv += [Activation(activation), Dropout(dropout)]
            self.layout.append(slots)
            cin = planes
        self.mconv = nn.ModuleList(mconv)
        res = []
        if residual:
            for ch in (res_channels or [in_channels]):
                res.append(nn.ModuleList([
                    MaskedConv(ch, planes, 1, use_mask=conv_mask, **bf16),
                    make_norm(normalization, planes, norm_groups)]))
        self.res = nn.ModuleList(res)
        self.out = nn.ModuleList([Activation(activation), Dropout(dropout)])

    def out_time(self, t_in: int) -> int:
        """Output frames at ``t_in`` input frames."""
        for slots in self.layout:
            for i in slots['convs']:
                t_in = self.mconv[i].out_time(t_in)
        return t_in

    def _unit(self, slots, x, lens, seq_len):
        """One repeat's conv(s), norm and GroupShuffle. Under tensor
        parallelism each sharded conv gives this rank's output channels
        (a conv that feeds another has them gathered first) and the norm
        gathers them after itself (``norm_gathered``). Under sequence
        parallelism ``x`` is this rank's range of ``seq_len`` frames;
        returns the output's global length with it."""
        convs = [self.mconv[i] for i in slots['convs']]
        if self.fused:
            dw, pw = convs
            # K6/K7 on the whole x and depthwise weight and this rank's
            # pointwise columns; the ranks' dwdw are partial sums
            sliced = pw.out_sharded
            wdw = tp.whole_param(dw.conv.weight, partial=sliced)
            wdw = wdw[:, 0, :].t().contiguous()                 # [K, C]
            wpw = pw.conv.weight[:, :, 0].t().contiguous()      # [Cin, Cout]
            shift = None
            if seq_len is not None:
                # this rank's output range from the haloed input, unpadded;
                # the masks' lengths shifted to the two ranges' first frames
                in_lo = sp.local_range(seq_len)[0] - self.pad
                x, seq_len = sp.conv_input(x, 1, seq_len, self.kernel, 1,
                                           self.dilation, self.pad, self.pad)
                shift = (in_lo, sp.local_range(seq_len)[0])
            if sliced:
                x = tp.copy_to_model(x)
            if self.compute_dtype is not None:   # K6/K7 read bf16 x only
                x = x.to(self.compute_dtype)
            x = sep_conv1d(x.contiguous(), lens if self.conv_mask else None,
                           wdw, wpw, self.dilation, self.pad,
                           use_mask=self.conv_mask, shift=shift)
            if self.conv_mask and lens is not None:
                # the two MaskedConv updates (depthwise, then 1x1 pointwise)
                lens = (lens + 2 * self.pad
                        - self.dilation * (self.kernel - 1) - 1) + 1
        else:
            sliced = False
            for conv in convs:
                if sliced:
                    x = tp.gather_from_model(x, 2)
                x, lens = conv(x, lens, seq_len)
                if seq_len is not None:
                    seq_len = conv.out_time(seq_len)
                sliced = conv.out_sharded
            x = from_bf16(x)   # the norms and residuals run in float32
        x = norm_gathered(self.mconv[slots['norm']], x, sliced)
        if 'shuffle' in slots:
            x = self.mconv[slots['shuffle']](x)
        return x, lens, seq_len

    def forward(self, panes, lens, generator: torch.Generator | None = None,
                seq_len: int | None = None):
        x = panes[-1]
        lens_orig, len_orig = lens, seq_len
        for slots in self.layout:
            x, lens, seq_len = self._unit(slots, x, lens, seq_len)
            if 'act' in slots:
                x = self.mconv[slots['act']](x)
                x = self.mconv[slots['act'] + 1](x, generator, seq_len)
        if self.residual:
            branches = panes if self.dense_residual else [panes[-1]]
            for (conv, norm), res_in in zip(self.res, branches):
                r, _ = conv(res_in, lens_orig, len_orig)
                r = norm_gathered(norm, from_bf16(r), conv.out_sharded)
                x = x + r if self.residual_mode == 'add' else torch.maximum(
                    x, r)
        x = self.out[0](x)
        return self.out[1](x, generator, seq_len), lens


class Jasper(nn.Module):
    """Jasper encoder (``jasper_blocks[:mid_layers]``) + 1x1 head.

    Block defaults: repeat 1, stride 1, dilation 1, ReLU, residual,
    separable, masked convs, batch norm, dropout ``dropout_default``. With a
    ``generator``, every conv weight is drawn from it by ``init_mode`` and
    the head bias starts at zero; the module is built on the CPU and moved
    to ``device``. ``compute_dtype`` (None: float32; ``torch.bfloat16``)
    is the JAX package's ``model.compute_dtype``; the parameters are
    float32 either way.
    """

    eval_emits_probs = True

    def __init__(self, jasper_blocks, num_labels: int, input_size: int = 64,
                 mid_layers: int = 1, init_mode: str = 'xavier_uniform',
                 remat: bool = False, dropout_default: float = 0.0,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = 'cpu',
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        specs = [dict(b) for b in list(jasper_blocks)[:mid_layers]]
        self.remat = bool(remat)
        self.compute_dtype = compute_dtype
        blocks = []
        panes = [input_size]
        for b in specs:
            dense = bool(b.get('residual_dense', False))
            planes = int(b['layer_size'])
            blocks.append(JasperBlock(
                panes[-1], planes,
                repeat=int(b.get('repeat', 1)),
                kernel_size=int(b['kernel_size']),
                kernel_size_factor=float(b.get('kernel_size_factor', 1.0)),
                stride=int(b.get('stride', 1)),
                dilation=int(b.get('dilation', 1)),
                dropout=float(b.get('dropout', dropout_default)),
                activation=b.get('activation', 'relu'),
                residual=bool(b.get('residual', True)),
                groups=int(b.get('groups', 1)),
                separable=bool(b.get('separable', True)),
                heads=int(b.get('heads', -1)),
                normalization=b.get('normalization', 'batch'),
                norm_groups=int(b.get('norm_groups', 1)),
                residual_mode=b.get('residual_mode', 'add'),
                dense_residual=dense,
                conv_mask=bool(b.get('conv_mask', True)),
                res_channels=list(panes) if dense else [panes[-1]],
                compute_dtype=compute_dtype))
            panes = panes + [planes] if dense else [planes]
        self.jasper_encoder = nn.ModuleList(blocks)
        self.final_layer = nn.Sequential(nn.Conv1d(panes[-1], num_labels, 1,
                                                   bias=True))
        self.scaling_factor = 1
        for b in specs:
            self.scaling_factor *= int(b.get('stride', 1))
        if generator is not None:
            for m in self.modules():
                if isinstance(m, nn.Conv1d):
                    init_conv_(m.weight, init_mode, generator)
            nn.init.zeros_(self.final_layer[0].bias)
        self.to(device)

    def out_time(self, t_in: int) -> int:
        """Output frames at ``t_in`` feature frames."""
        for block in self.jasper_encoder:
            t_in = block.out_time(t_in)
        return t_in

    def _run_block(self, block, panes, lens, generator, seq_len):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(panes, lens, generator, seq_len)
        state = None if generator is None else generator.get_state()

        def run(panes, lens):
            # In the recomputation, replay the block's dropout draws.
            if state is not None:
                generator.set_state(state)
            return block(panes, lens, generator, seq_len)
        return checkpoint(run, panes, lens, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_statistics(block)))

    def forward(self, x: torch.Tensor, input_lengths=None,
                generator: torch.Generator | None = None,
                seq_len: int | None = None):
        """x: [B, T, F] features. Returns (log_probs in train mode, probs in
        eval mode, [B, T', L]; out_lengths [B] int32 or None). With
        ``seq_len`` (sequence parallelism), ``x`` is this rank's range of
        ``seq_len`` frames and so is the output of ``out_time(seq_len)``;
        the lengths stay global."""
        lens = (None if input_lengths is None
                else input_lengths.to(torch.float32))
        panes = [x]
        for block in self.jasper_encoder:
            out, lens = self._run_block(block, panes, lens, generator,
                                        seq_len)
            if seq_len is not None:
                seq_len = block.out_time(seq_len)
            panes = panes + [out] if block.dense_residual else [out]
            x = out
        head = self.final_layer[0]
        conv = F.conv1d if self.compute_dtype is None else conv1d_bf16
        logits = from_bf16(conv(x.transpose(1, 2), head.weight,
                                head.bias).transpose(1, 2))
        out = (F.log_softmax(logits, dim=-1) if self.training
               else F.softmax(logits, dim=-1)).contiguous()
        if lens is None:
            return out, None
        return out, lens.to(torch.int32)
