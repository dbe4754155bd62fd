"""BatchNorm folding of a Wav2Letter stack for serving.

The counterpart of ``fold_batchnorm`` in the JAX package's
``serving/streaming.py``, where the streaming and offline serving paths both
find it. Eval-mode BatchNorm is the affine map
``(x - mean) / sqrt(var + eps) * scale + bias`` (eps 1e-3), so it composes
into the conv before it: ``w' = w * g`` and ``b' = (b - mean) * g + beta``
with ``g = scale / sqrt(var + eps)``. The arithmetic is numpy float32 in the
JAX package's order, so the same weights fold to the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

BN_EPS = 1e-3


def _state_dict(model_or_state) -> dict:
    if isinstance(model_or_state, torch.nn.Module):
        model_or_state = model_or_state.state_dict()
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in model_or_state.items()}


def _kernel(weight) -> np.ndarray:
    """torch conv weight [C_out, C_in, K] -> the JAX layout [K, C_in, C_out]."""
    return np.ascontiguousarray(np.asarray(weight, np.float32)
                                .transpose(2, 1, 0))


def fold_batchnorm(model_or_state, num_blocks: int | None = None):
    """Fold eval-mode BatchNorm into each block's conv kernel and bias.

    ``model_or_state``: the port's ``Wav2Letter`` or its state dict (the
    reference layout ``conv1ds.conv1d_{i}.conv1`` / ``.batch_norm``).
    ``num_blocks``: the blocks before the 1x1 head, checked against the
    model's (the JAX function's argument; the port's model knows it).
    Returns ``[(w [k, C_in, C_out], b [C_out])]`` as numpy float32 for the
    blocks, plus the unfolded head, in the JAX package's layout, so that an
    artifact written from either package holds the same arrays.
    """
    sd = _state_dict(model_or_state)
    n_convs = sum(1 for k in sd if k.startswith('conv1ds.conv1d_')
                  and k.endswith('.conv1.weight'))
    if num_blocks is None:
        num_blocks = n_convs - 1
    if num_blocks != n_convs - 1:
        raise ValueError(f'{num_blocks} blocks asked for, but the model has '
                         f'{n_convs - 1} blocks before its head')
    folded = []
    for i in range(num_blocks):
        key = f'conv1ds.conv1d_{i}'
        w = _kernel(sd[f'{key}.conv1.weight'])
        b = np.asarray(sd[f'{key}.conv1.bias'], np.float32)
        if f'{key}.batch_norm.weight' in sd:
            bn = f'{key}.batch_norm'
            g = (np.asarray(sd[f'{bn}.weight'], np.float32)
                 / np.sqrt(np.asarray(sd[f'{bn}.running_var'], np.float32)
                           + BN_EPS))
            b = (b - np.asarray(sd[f'{bn}.running_mean'], np.float32)) * g \
                + np.asarray(sd[f'{bn}.bias'], np.float32)
            w = w * g[None, None, :]
        folded.append((w, b))
    head = f'conv1ds.conv1d_{num_blocks}.conv1'
    folded.append((_kernel(sd[f'{head}.weight']),
                   np.asarray(sd[f'{head}.bias'], np.float32)))
    return folded
