"""Carry Wav2Letter weights across from the JAX package.

A flax variable tree ``{'params', 'batch_stats'}`` (numpy arrays, e.g. a
restored checkpoint passed through ``jax.device_get``) becomes the port's
``state_dict``: conv kernels ``[K, C_in, C_out]`` -> ``[C_out, C_in, K]``;
BatchNorm ``scale``/``bias`` params and ``mean``/``var`` stats ->
``weight``/``bias``/``running_mean``/``running_var``. The keys are the
reference torch layout that ``Wav2Letter`` uses, so
``load_state_dict(strict=True)`` takes the result as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_flax(variables) -> dict[str, torch.Tensor]:
    """Port ``state_dict`` from a flax Wav2Letter variable tree."""
    params = variables['params']
    stats = variables.get('batch_stats', {}) or {}
    if not params or not all(n.startswith('conv1d_') for n in params):
        raise ValueError('not a Wav2Letter variable tree (expected '
                         f'conv1d_* blocks, got {sorted(params)[:4]})')
    names = sorted(params, key=lambda n: int(n[len('conv1d_'):]))

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}
    for name in names:
        blk = params[name]
        key = f'conv1ds.{name}'
        sd[f'{key}.conv1.weight'] = t(
            np.asarray(blk['Conv_0']['kernel']).transpose(2, 1, 0))
        sd[f'{key}.conv1.bias'] = t(blk['Conv_0']['bias'])
        if 'BatchNorm_0' in blk:
            bn, st = blk['BatchNorm_0'], stats[name]['BatchNorm_0']
            sd[f'{key}.batch_norm.weight'] = t(bn['scale'])
            sd[f'{key}.batch_norm.bias'] = t(bn['bias'])
            sd[f'{key}.batch_norm.running_mean'] = t(st['mean'])
            sd[f'{key}.batch_norm.running_var'] = t(st['var'])
            sd[f'{key}.batch_norm.num_batches_tracked'] = torch.tensor(0)
    return sd
