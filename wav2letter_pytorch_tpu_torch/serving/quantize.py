"""int8 quantization of a BN-folded stack, and static activation scales.

The counterpart of the JAX package's ``serving/quantize.py``. Weights are
quantized symmetrically per output channel after BatchNorm folding
(``fold.fold_batchnorm``), so the BN scale is absorbed before rounding.
``quantize_folded`` is numpy float32, as the JAX function is, and gives the
same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_folded(folded):
    """[(w [k, C_in, C_out], b)] -> [(w_q int8, scale [C_out] f32, b)].

    Symmetric per output channel: ``scale = max|w[..., c]| / 127``.
    """
    out = []
    for w, b in folded:
        w = np.asarray(w, np.float32)
        scale = np.max(np.abs(w), axis=(0, 1)) / 127.0
        scale = np.maximum(scale, 1e-12).astype(np.float32)
        q = np.clip(np.round(w / scale[None, None, :]), -127, 127) \
            .astype(np.int8)
        out.append((q, scale,
                    None if b is None else np.asarray(b, np.float32)))
    return out


def calibrate_activation_scales(layers, folded, frontend, audio, lengths,
                                percentile: float = 99.9,
                                padding_mode: str = 'reflect'):
    """Static per-layer activation scales for ``offline_forward_q8``.

    Runs the f32 folded forward (``folded`` must be the f32 fold) over the
    calibration audio ``[B, T_samples]`` on the frontend's device and takes
    the ``percentile`` of |input| at every conv (and the head) over each
    row's valid frames only, divided by 127. Returns a list of floats, one
    a layer of ``folded``.
    """
    from .infer import offline_forward
    dev = frontend.fb_t.device
    audio = torch.as_tensor(np.asarray(audio, np.float32), device=dev)
    lengths = torch.as_tensor(np.asarray(lengths), device=dev)
    with torch.no_grad():
        feats, flens = frontend(audio, lengths)
        _, _, acts = offline_forward(layers, folded, feats, flens,
                                     padding_mode=padding_mode,
                                     return_activations=True)
    strides = [int(l.get('stride', 1)) for l in layers]
    cur = flens.cpu().numpy().astype(np.int64)
    scales = []
    for i, a in enumerate(acts):
        a = a.cpu().numpy()
        vals = np.concatenate([np.abs(a[b, :cur[b]]).ravel()
                               for b in range(a.shape[0])])
        p = float(np.percentile(vals, percentile))
        scales.append(max(p, 1e-6) / 127.0)
        if i < len(strides):
            cur = cur // strides[i]
    return scales


def quantized_bytes(folded_q) -> int:
    """Total parameter bytes of a quantized stack (int8 + scales + bias)."""
    total = 0
    for q, scale, b in folded_q:
        total += q.size + scale.nbytes + (0 if b is None else b.nbytes)
    return total
