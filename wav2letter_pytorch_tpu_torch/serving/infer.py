"""Serving forward of a BN-folded Wav2Letter stack: f32, int8 weights, or
int8 weights and activations.

The counterpart of the JAX package's ``serving/infer.py``. ``folded`` is
what ``fold_batchnorm`` returns (``(w [k, C_in, C_out], b)`` a layer, the
1x1 head last) or what ``quantize.quantize_folded`` returns (``(q int8,
scale [C_out], b)``), as numpy arrays or, after ``to_device``, as tensors
on the card.

``offline_forward`` reproduces the eval-mode ``Wav2Letter`` on the folded
weights: each layer's SAME padding (reflect or zeros) from the padded batch
length (``models/base.py::same_pad_amount``), a float32 cuDNN convolution
(TF32 off, as ``runtime.resolve_device`` leaves it), the bias, clamp(0, 20),
then the head and log_softmax.

``offline_forward_q8`` quantizes each layer's input to int8 with a
symmetric scale (dynamic per row over its valid frames, or static from
calibration), and computes the convolution as an im2col of the int8 input
(``Tensor.unfold`` over time, the dilation taken by striding the taps)
times the int8 weights with int32 accumulation (``torch._int_mm``:
cuBLASLt's int8 tensor cores on the card). Integer sums are exact, so the
accumulators equal the JAX package's bit for bit on the same int8 inputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import same_pad_amount

ACT_CLAMP = (0.0, 20.0)


def _layer_geometry(layers):
    return [(int(l['kernel_size']), int(l.get('stride', 1)),
             int(l.get('dilation', 1))) for l in layers]


def to_device(folded, device):
    """``folded`` with every array a tensor on ``device``, each in the
    layout its product reads, under the JAX package's shapes:

    - an f32 kernel ``[k, C_in, C_out]`` is a view of a contiguous
      ``[C_out, C_in, k]`` tensor, the layout ``F.conv1d`` takes;
    - an int8 kernel ``[k, C_in, C_out]`` is a view of a contiguous
      ``[C_out, k * C_in]`` tensor: reshaped to ``[k * C_in, C_out]`` it is
      the column-major right operand of ``torch._int_mm``.
    """
    dev = torch.device(device)
    out = []
    for wb in folded:
        w = np.asarray(wb[0])
        k, cin, cout = w.shape
        if len(wb) == 2:
            dw = torch.from_numpy(np.ascontiguousarray(
                w.transpose(2, 1, 0), np.float32)).to(dev).permute(2, 1, 0)
        else:
            dw = torch.from_numpy(np.ascontiguousarray(
                w.reshape(k * cin, cout).T)).to(dev).t().reshape(k, cin, cout)
        rest = tuple(None if a is None else _tensor(a, dev)
                     for a in wb[1:])
        out.append((dw,) + rest)
    return out


def _tensor(a, device) -> torch.Tensor:
    """A tensor on ``device`` (numpy arrays copied, which also takes the
    read-only arrays of a loaded artifact)."""
    if torch.is_tensor(a):
        return a.to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _materialize(wb, device):
    """(w, b) as float32 tensors on ``device``: passed through, or an int8
    ``(q, scale, b)`` dequantized as ``q * scale``. ``b`` may be None
    (bias-free convs)."""
    b = wb[-1]
    b = None if b is None else _tensor(b, device)
    w = _tensor(wb[0], device)
    if len(wb) == 3:
        scale = _tensor(wb[1], device)
        w = w.to(torch.float32) * scale[None, None, :]
    return w, b


def _pad_time(x: torch.Tensor, left: int, right: int,
              mode: str) -> torch.Tensor:
    """SAME padding of ``x [B, T, C]`` along time: reflect (about the edge
    frames) or zeros. Index-based, so it takes int8 as well as float."""
    if not (left or right):
        return x
    t = x.shape[1]
    if mode == 'reflect':
        # Built on x's device: a copy from the host would wait for the
        # device's queue.
        dev = x.device
        idx = torch.cat([torch.arange(left, 0, -1, device=dev),
                         torch.arange(t, device=dev),
                         torch.arange(t - 2, t - 2 - right, -1, device=dev)])
        return x.index_select(1, idx)
    B, _, C = x.shape
    return torch.cat([x.new_zeros(B, left, C), x, x.new_zeros(B, right, C)],
                     dim=1)


def offline_forward(layers, folded, feats: torch.Tensor, input_lengths=None,
                    padding_mode: str = 'reflect',
                    return_activations: bool = False):
    """Run the folded conv stack over ``feats [B, T, M]`` on its device.

    ``layers``: the model layer spec truncated to mid_layers. ``folded``:
    ``fold_batchnorm``'s f32 weights or ``quantize_folded``'s int8 ones
    (dequantized here: weight-only int8, float32 math). ``padding_mode``
    must be the trained model's (reflect | zeros). ``return_activations``
    also returns each conv's (and the head's) input ``[B, T, C]``, which
    int8 calibration reads. Returns ``(log_probs [B, T', L], out_lengths |
    None[, activations])``.
    """
    dev = feats.device
    x = feats.to(torch.float32).transpose(1, 2)      # [B, C, T]
    scale_total = 1
    acts = []
    mode = 'reflect' if padding_mode == 'reflect' else 'constant'
    for (k, s, d), wb in zip(_layer_geometry(layers), folded[:-1]):
        w, b = _materialize(wb, dev)
        if return_activations:
            acts.append(x.transpose(1, 2))
        left, right = same_pad_amount(x.shape[-1], k, s, d)
        if left or right:
            x = F.pad(x, (left, right), mode=mode)
        x = torch.clamp(F.conv1d(x, w.permute(2, 1, 0), b, stride=s,
                                 dilation=d), *ACT_CLAMP)
        scale_total *= s
    x = x.transpose(1, 2)                              # [B, T', C]
    if return_activations:
        acts.append(x)
    wh, bh = _materialize(folded[-1], dev)
    logits = torch.matmul(x, wh[0])
    if bh is not None:
        logits = logits + bh
    logp = F.log_softmax(logits, dim=-1)
    out_lens = None if input_lengths is None else \
        torch.as_tensor(input_lengths, device=dev).to(torch.int32) \
        // scale_total
    if return_activations:
        return logp, out_lens, acts
    return logp, out_lens


def dynamic_act_scale(x: torch.Tensor, valid_lengths=None) -> torch.Tensor:
    """Per-row symmetric int8 scale ``max|x| / 127`` of ``x [B, T, C]``
    ([B, 1, 1]), over the first ``valid_lengths[b]`` frames when given."""
    a = x.abs()
    if valid_lengths is not None:
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                < valid_lengths[:, None])[:, :, None]
        a = torch.where(mask, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))
    amax = torch.clamp(torch.amax(a, dim=(1, 2), keepdim=True), min=1e-6)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, one bit off the CPU's (and JAX's) quotient.
    # Filled on the device: a copy from the host would wait for its queue.
    return amax / torch.full_like(amax, 127.0)


def quantize_act(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x / a_scale), -127, 127)`` as int8 (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)


def _act_scale(x, act_scales, i, valid_lengths):
    if act_scales is not None:
        return torch.tensor(float(act_scales[i]), dtype=torch.float32,
                            device=x.device).reshape(1, 1, 1)
    return dynamic_act_scale(x, valid_lengths)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` -> int32 ``[M, N]`` through
    ``torch._int_mm``, zero-padded to the shapes its CUDA path takes
    (M > 16, K and N multiples of 8); zero rows and columns add nothing to
    an integer sum."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    # Row-major and dense: an im2col of one row at dilation 1 reshapes to
    # a view whose windows overlap, which the product does not read right.
    a = a.contiguous()
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    if b.stride(0) != 1:        # column-major, as cuBLASLt's int8 path reads
        b = b.t().contiguous().t()
    out = torch._int_mm(a, b)
    return out[:m, :n] if (pm or pn) else out


def im2col(xq: torch.Tensor, k: int, stride: int, dilation: int,
           padding_mode: str = 'reflect') -> torch.Tensor:
    """The rows ``[B, T_out, k * C_in]`` of a SAME 1-D convolution over
    ``xq [B, T, C_in]``: padded, windows taken over time by
    ``Tensor.unfold`` with the taps strided by the dilation, tap-major
    within a row (the order of ``q [k, C_in, C_out]`` reshaped). A view
    where the strides allow it, else a copy."""
    left, right = same_pad_amount(xq.shape[1], k, stride, dilation)
    return _windows(_pad_time(xq, left, right, padding_mode), k, stride,
                    dilation)


def _windows(xp: torch.Tensor, k: int, stride: int,
             dilation: int) -> torch.Tensor:
    """The rows ``[B, T_out, k * C_in]`` of a VALID 1-D convolution over
    ``xp [B, T, C_in]`` (``im2col`` without the padding)."""
    B, _, cin = xp.shape
    cols = xp.unfold(1, (k - 1) * dilation + 1, stride)[..., ::dilation]
    return cols.transpose(2, 3).reshape(B, cols.shape[1], k * cin)


def conv_q8_valid(xq: torch.Tensor, q: torch.Tensor, stride: int,
                  dilation: int) -> torch.Tensor:
    """int32 accumulators ``[B, T_out, C_out]`` of a VALID 1-D convolution
    of int8 ``xq [B, T, C_in]`` with int8 ``q [k, C_in, C_out]``: the
    windows' rows times ``q`` as ``[k * C_in, C_out]``. The streaming
    stack runs it over each layer's carry and new frames."""
    k, cin, cout = q.shape
    cols = _windows(xq, k, stride, dilation)
    B, t_out, _ = cols.shape
    return int_mm(cols.reshape(B * t_out, k * cin),
                  q.reshape(k * cin, cout)).view(B, t_out, cout)


def conv_q8(xq: torch.Tensor, q: torch.Tensor, stride: int, dilation: int,
            padding_mode: str = 'reflect') -> torch.Tensor:
    """int32 accumulators ``[B, T_out, C_out]`` of a SAME 1-D convolution
    of int8 ``xq [B, T, C_in]`` with int8 ``q [k, C_in, C_out]``: the
    ``im2col`` rows times ``q`` as ``[k * C_in, C_out]``."""
    left, right = same_pad_amount(xq.shape[1], q.shape[0], stride, dilation)
    return conv_q8_valid(_pad_time(xq, left, right, padding_mode), q, stride,
                         dilation)


def offline_forward_q8(layers, folded_q, feats: torch.Tensor,
                       input_lengths=None, padding_mode: str = 'reflect',
                       act_scales=None, f32_layers=()):
    """Full int8 inference: int8 weights and int8 activations.

    Each layer's input is quantized with a symmetric scale, the convolution
    accumulates int8 x int8 in int32 (``conv_q8``), and the output is
    dequantized as ``y * (a_scale * w_scale)``. ``act_scales``: static
    per-layer scales from ``quantize.calibrate_activation_scales`` (one a
    conv, the head last); without them each row's scale is ``max|x| / 127``
    over its valid frames (padding excluded when ``input_lengths`` is
    given). ``f32_layers``: layer indices (and/or ``'head'``) run with the
    dequantized weights in float32 instead. Returns ``(log_probs [B, T',
    L], out_lengths | None)``.
    """
    dev = feats.device
    x = feats.to(torch.float32)                        # [B, T, C]
    cur_len = None if input_lengths is None else \
        torch.as_tensor(input_lengths, device=dev).to(torch.int32)
    scale_total = 1
    mode = 'reflect' if padding_mode == 'reflect' else 'constant'
    for i, ((k, s, d), (q, w_scale, b)) in enumerate(
            zip(_layer_geometry(layers), folded_q[:-1])):
        q, w_scale, b = (_tensor(a, dev) for a in (q, w_scale, b))
        if i in f32_layers:
            w = q.to(torch.float32) * w_scale[None, None, :]
            xt = x.transpose(1, 2)
            left, right = same_pad_amount(xt.shape[-1], k, s, d)
            if left or right:
                xt = F.pad(xt, (left, right), mode=mode)
            y = F.conv1d(xt, w.permute(2, 1, 0), stride=s,
                         dilation=d).transpose(1, 2)
        else:
            a_scale = _act_scale(x, act_scales, i, cur_len)
            y = conv_q8(quantize_act(x, a_scale), q, s, d, padding_mode)
            y = y.to(torch.float32) * (a_scale * w_scale[None, None, :])
        x = torch.clamp(y + b, *ACT_CLAMP)
        scale_total *= s
        if cur_len is not None:
            cur_len = cur_len // s
    qh, sh, bh = (_tensor(a, dev) for a in folded_q[-1])
    if 'head' in f32_layers:
        wh = qh.to(torch.float32)[0] * sh[None, :]
        logits = torch.matmul(x, wh) + bh
    else:
        a_scale = _act_scale(x, act_scales, len(folded_q) - 1, cur_len)
        B, T, C = x.shape
        acc = int_mm(quantize_act(x, a_scale).reshape(B * T, C), qh[0])
        logits = acc.view(B, T, -1).to(torch.float32) \
            * (a_scale * sh[None, None, :]) + bh
    logp = F.log_softmax(logits, dim=-1)
    if input_lengths is None:
        return logp, None
    return logp, torch.as_tensor(input_lengths, device=dev).to(
        torch.int32) // scale_total
