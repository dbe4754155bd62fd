"""Quantization-aware finetuning (QAT) of the folded serving graph.

The counterpart of the JAX package's ``serving/qat.py``. Full int8
inference (``infer.offline_forward_q8``) quantizes every layer's weights
and inputs; QAT finetunes the BN-folded float32 weights through a
*fake-quantized* forward that reproduces that graph operation for
operation, with straight-through estimators (STE) for the rounding, and
the finetuned fold is exported as an ordinary int8 artifact.

* The weights fake-quantize per output channel with the scale
  ``max|w| / 127`` taken from the live weights each step (the rule of
  ``quantize.quantize_folded``), so ``quantize_folded`` of the returned
  fold is, bit for bit, what training simulated.
* Activation scales stay fixed at the artifact's calibrated values (or
  are dynamic a row, ``infer.dynamic_act_scale``); every scale is
  detached, as ``stop_gradient`` holds them in JAX.
* Both clips, and the ``clip(y + b, 0, 20)`` after each conv, are
  ``min(max(x, lo), hi)`` over tensor bounds: at a tie the gradient splits
  0.5 / 0.5, as ``jnp.clip``'s does. ``torch.clamp`` would pass 1 there,
  and each channel's largest weight always lands on +-127.
* Padding follows the activation fake-quant, by index
  (``infer._pad_time``), as the int8 path pads its int8 tensor.
* A quantized layer's conv (``QuantConv``) sums the integers of its
  fake-quantized input and weight exactly, as ``offline_forward_q8``
  does (``infer.conv_q8_valid``: int32 sums, on the card int8 tensor
  cores), and its gradient is the float32 conv's (cuDNN's dgrad and
  wgrad). The values are the JAX graph's float32 conv of the same grid
  values up to rounding, but float32 sums round a tie of the next layer's
  quantizer now and then, and over 20 trained layers those flips grew to
  3.9e-2 in log p against the deployed graph (a W2L-20 run on the card);
  exact sums make the forward the deployed graph's, bit for bit.
* The loss is the trainer's ``masked_ctc_mean``: on the card kernel K2
  forward and K3 backward; the frontend (kernel K1) runs in the step
  without a gradient.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import same_pad_amount
from .infer import (_layer_geometry, _pad_time, conv_q8_valid,
                    dynamic_act_scale)

QMAX = 127.0
ACT_CLIP = (0.0, 20.0)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clip(x, lo, hi)`` as ``jnp.clip`` computes it and differentiates
    it: a gradient of 0.5 where ``x`` equals a bound."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) (half to even) with the identity's gradient."""
    return x + (torch.round(x) - x).detach()


def _fake_quant_weight(w: torch.Tensor):
    """``(fake_quant_weight(w), scale [C_out])``."""
    with torch.no_grad():
        amax = torch.amax(w.abs(), dim=(0, 1))
        # A tensor divisor: the card divides by a Python scalar as a
        # multiply by its reciprocal, off numpy's quotient.
        scale = torch.clamp(amax / torch.full_like(amax, QMAX), min=1e-12)
    q = _clip(ste_round(w / scale[None, None, :]), -QMAX, QMAX)
    return q * scale[None, None, :], scale


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake-quant of ``w [k, C_in,
    C_out]``: ``quantize_folded``'s values (scale ``max|w| / 127``,
    floored at 1e-12, detached), rounded and clipped through the STE."""
    return _fake_quant_weight(w)[0]


def fake_quant_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 fake-quant of activations with a fixed scale (a
    float, or a tensor that broadcasts against ``x``), detached."""
    if not torch.is_tensor(scale):
        scale = torch.full((), float(scale), dtype=torch.float32,
                           device=x.device)
    scale = scale.detach()
    return _clip(ste_round(x / scale), -QMAX, QMAX) * scale


class QuantConv(torch.autograd.Function):
    """VALID 1-D convolution of fake-quantized ``xi [B, T, C_in]`` (values
    on ``a_scale``'s grid, ``[1 or B, 1, 1]``) with fake-quantized ``wi [k,
    C_in, C_out]`` (on ``w_scale [C_out]``'s grid) -> ``[B, T_out,
    C_out]``. Forward: the grid integers' int32 sums times ``a_scale *
    w_scale``, ``offline_forward_q8``'s arithmetic; backward: the float32
    conv's gradients with respect to ``xi`` and ``wi``."""

    @staticmethod
    def forward(ctx, xi, wi, a_scale, w_scale, stride: int, dilation: int):
        # The grid values are q * scale rounded once: dividing back lands
        # within a few ulps of the integer q.
        xq = torch.round(xi / a_scale).to(torch.int8)
        q = torch.round(wi / w_scale[None, None, :]).to(torch.int8)
        acc = conv_q8_valid(xq, q, stride, dilation)
        ctx.save_for_backward(xi, wi)
        ctx.stride, ctx.dilation = stride, dilation
        return acc.to(torch.float32) * (a_scale * w_scale[None, None, :])

    @staticmethod
    def backward(ctx, grad):
        xi, wi = ctx.saved_tensors
        x, w, g = xi.transpose(1, 2), wi.permute(2, 1, 0), grad.transpose(1, 2)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv1d_input(
                x.shape, w, g, stride=ctx.stride,
                dilation=ctx.dilation).transpose(1, 2)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv1d_weight(
                x, w.shape, g, stride=ctx.stride,
                dilation=ctx.dilation).permute(2, 1, 0)
        return gx, gw, None, None, None, None


def qat_forward(layers, params, feats: torch.Tensor, input_lengths=None,
                act_scales=None, padding_mode: str = 'reflect',
                f32_layers=()):
    """Fake-quantized folded forward: ``offline_forward_q8``, with
    gradients.

    ``params``: ``(w [k, C_in, C_out], b)`` float32 tensors, one a conv and
    the 1x1 head last (the trainable fold). Each conv fake-quantizes its
    input with the layer's activation scale and its weight with the live
    per-channel rule; then conv (``QuantConv``) -> + bias -> clip(0, 20).
    Layers in ``f32_layers`` (indices, or ``'head'``) keep their input in
    float32 but still fake-quantize their weight, as
    ``offline_forward_q8``'s float32 branch dequantizes the int8 weights,
    and convolve in float32 (``F.conv1d``).
    ``act_scales``: static scales (one a conv, the head last; floats, or
    a tensor on the device, which saves a copy from the host a call); None
    takes each row's ``max|x| / 127`` over its valid frames. Returns
    ``(log_probs [B, T', L], out_lengths | None)``.
    """
    dev = feats.device
    x = feats.to(torch.float32)                        # [B, T, C]
    cur_len = None if input_lengths is None else \
        torch.as_tensor(input_lengths, device=dev).to(torch.int32)
    static = None if act_scales is None else torch.as_tensor(
        act_scales, dtype=torch.float32, device=dev)

    def a_scale(x, i, cur_len):
        if static is not None:
            return static[i].reshape(1, 1, 1)
        return dynamic_act_scale(x.detach(), cur_len)

    mode = 'reflect' if padding_mode == 'reflect' else 'zeros'
    scale_total = 1
    for i, ((k, s, d), (w, b)) in enumerate(
            zip(_layer_geometry(layers), params[:-1])):
        wi, w_scale = _fake_quant_weight(w)
        left, right = same_pad_amount(x.shape[1], k, s, d)
        if i in f32_layers:
            y = F.conv1d(_pad_time(x, left, right, mode).transpose(1, 2),
                         wi.permute(2, 1, 0), stride=s,
                         dilation=d).transpose(1, 2)
        else:
            sa = a_scale(x, i, cur_len)
            y = QuantConv.apply(
                _pad_time(fake_quant_act(x, sa), left, right, mode), wi, sa,
                w_scale, s, d)
        x = _clip(y + b, *ACT_CLIP)
        scale_total *= s
        if cur_len is not None:
            cur_len = cur_len // s
    wh, bh = params[-1]
    wi, w_scale = _fake_quant_weight(wh)
    if 'head' in f32_layers:
        logits = torch.einsum('btc,cl->btl', x, wi[0]) + bh
    else:
        sa = a_scale(x, len(params) - 1, cur_len)
        logits = QuantConv.apply(fake_quant_act(x, sa), wi, sa, w_scale, 1,
                                 1) + bh
    logp = F.log_softmax(logits, dim=-1)
    if input_lengths is None:
        return logp, None
    return logp, torch.as_tensor(input_lengths, device=dev).to(
        torch.int32) // scale_total


def init_params(folded, device) -> list:
    """The fold's ``(w, b)`` as float32 leaf tensors on ``device`` that
    require a gradient: what ``qat_step`` trains."""
    return [tuple(torch.tensor(np.asarray(a, np.float32), device=device,
                               requires_grad=True) for a in wb)
            for wb in folded]


def make_optimizer(params, optimizer: str, learning_rate: float):
    """``optax.lamb`` (``'lamb'``) or ``optax.adam`` (``'adam'``) over
    ``init_params``' tensors."""
    from ..optim import Adam, Lamb
    flat = [t for wb in params for t in wb]
    if optimizer == 'lamb':
        return Lamb(flat, lr=learning_rate)
    if optimizer == 'adam':
        return Adam(flat, lr=learning_rate)
    raise ValueError(f'unknown optimizer {optimizer!r}')


def qat_step(layers, params, opt, frontend, batch: dict, act_scales=None,
             padding_mode: str = 'reflect', f32_layers=()) -> torch.Tensor:
    """One QAT update on a batch of tensors on the device (``audio``,
    ``audio_lengths``, ``targets``, ``target_lengths``, ``batch_mask``):
    the frontend without a gradient, ``qat_forward``, ``masked_ctc_mean``,
    backward, ``opt.step()``. Returns the loss before the update (a
    tensor; read it only when it is needed)."""
    from ..training.trainer import masked_ctc_mean
    with torch.no_grad():
        feats, flens = frontend(batch['audio'], batch['audio_lengths'])
    logp, out_lens = qat_forward(layers, params, feats, flens,
                                 act_scales=act_scales,
                                 padding_mode=padding_mode,
                                 f32_layers=f32_layers)
    loss = masked_ctc_mean(logp, out_lens, batch['targets'],
                           batch['target_lengths'], batch['batch_mask'])
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def qat_finetune(layers, folded, frontend, loader, *, act_scales=None,
                 steps: int = 300, learning_rate: float = 1e-4,
                 optimizer: str = 'lamb', f32_layers=(),
                 padding_mode: str = 'reflect', log_every: int = 25,
                 progress=None):
    """Finetune a folded float32 stack against its int8 deployment graph.

    ``folded``: the f32 fold (``fold_batchnorm``; not int8: QAT starts from
    the true weights so it can move them off rounding boundaries).
    ``frontend``: the serving frontend (no dither; per-utterance or CMVN
    normalisation) on the device to train on. ``loader``: an iterable of
    batches of numpy arrays (a ``BucketBatchLoader``; iterating it again
    starts its next epoch). Runs ``steps`` updates of ``optimizer``
    (``'lamb'``, whose trust ratio makes ``learning_rate`` a relative
    drift a step, or ``'adam'``) on the masked-mean CTC loss of
    ``qat_forward``, logging ``(step, loss)`` every ``log_every`` steps and
    at the last into ``history`` (and ``progress``, a callable taking a
    line). Returns ``(new_folded, history)``: numpy float32 ``(w, b)``
    pairs in ``fold_batchnorm``'s layout.
    """
    from ..training.trainer import to_device
    dev = frontend.fb_t.device
    params = init_params(folded, dev)
    opt = make_optimizer(params, optimizer, learning_rate)
    if act_scales is not None:   # copied to the device once
        act_scales = torch.tensor([float(s) for s in act_scales],
                                  dtype=torch.float32, device=dev)
    history = []
    step = 0
    while step < steps:
        for batch in loader:
            if step >= steps:
                break
            loss = qat_step(layers, params, opt, frontend,
                            to_device(batch, dev), act_scales=act_scales,
                            padding_mode=padding_mode,
                            f32_layers=f32_layers)
            step += 1
            if step % log_every == 0 or step == steps:
                lv = float(loss)
                history.append((step, lv))
                if progress is not None:
                    progress(f'qat step {step}/{steps}: loss {lv:.4f}')
    new_folded = [tuple(t.detach().cpu().numpy() for t in wb)
                  for wb in params]
    return new_folded, history
