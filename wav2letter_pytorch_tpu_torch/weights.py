"""Carry Wav2Letter and Jasper weights across from the JAX package.

A flax variable tree ``{'params', 'batch_stats'}`` (numpy arrays, e.g. a
restored checkpoint passed through ``jax.device_get``) becomes the port's
``state_dict``: conv kernels ``[K, C_in/groups, C_out]`` ->
``[C_out, C_in/groups, K]``; BatchNorm ``scale``/``bias`` params and
``mean``/``var`` stats -> ``weight``/``bias``/``running_mean``/
``running_var``; GroupNorm (group, instance and layer norm) ``scale``/
``bias`` -> ``weight``/``bias``. The keys are the reference torch layout
that ``Wav2Letter`` and ``Jasper`` use, so ``load_state_dict(strict=True)``
takes the result as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(2, 1, 0))


def _put_norm(sd: dict, key: str, params, stats) -> None:
    sd[f'{key}.weight'] = _t(params['scale'])
    sd[f'{key}.bias'] = _t(params['bias'])
    if stats is not None:
        sd[f'{key}.running_mean'] = _t(stats['mean'])
        sd[f'{key}.running_var'] = _t(stats['var'])
        sd[f'{key}.num_batches_tracked'] = torch.tensor(0)


def _wav2letter(params, stats) -> dict[str, torch.Tensor]:
    names = sorted(params, key=lambda n: int(n[len('conv1d_'):]))
    sd: dict[str, torch.Tensor] = {}
    for name in names:
        blk = params[name]
        key = f'conv1ds.{name}'
        sd[f'{key}.conv1.weight'] = _kernel(blk['Conv_0']['kernel'])
        sd[f'{key}.conv1.bias'] = _t(blk['Conv_0']['bias'])
        if 'BatchNorm_0' in blk:
            _put_norm(sd, f'{key}.batch_norm', blk['BatchNorm_0'],
                      stats[name]['BatchNorm_0'])
    return sd


def _jasper(params, stats, jasper_blocks) -> dict[str, torch.Tensor]:
    """The reference ``mconv`` indices: per repeat the conv(s), the norm, a
    GroupShuffle slot when ``groups > 1``, and act + dropout slots after
    every repeat but the last."""
    blocks = sorted((n for n in params if n.startswith('block')),
                    key=lambda n: int(n[len('block'):]))
    sd: dict[str, torch.Tensor] = {}
    for bi, name in enumerate(blocks):
        bp, bs = params[name], stats.get(name, {})
        groups = int(jasper_blocks[bi].get('groups', 1))
        key = f'jasper_encoder.{bi}'
        idx = r = 0
        while f'rep{r}_norm' in bp:
            convs = ([f'rep{r}_dw', f'rep{r}_pw'] if f'rep{r}_dw' in bp
                     else [f'rep{r}_conv'])
            for cn in convs:
                sd[f'{key}.mconv.{idx}.conv.weight'] = _kernel(
                    bp[cn]['Conv_0']['kernel'])
                idx += 1
            _put_norm(sd, f'{key}.mconv.{idx}', bp[f'rep{r}_norm'],
                      bs.get(f'rep{r}_norm'))
            idx += 1 + (groups > 1)
            r += 1
            if f'rep{r}_norm' in bp:
                idx += 2
        j = 0
        while f'res{j}_conv' in bp:
            sd[f'{key}.res.{j}.0.conv.weight'] = _kernel(
                bp[f'res{j}_conv']['Conv_0']['kernel'])
            _put_norm(sd, f'{key}.res.{j}.1', bp[f'res{j}_norm'],
                      bs.get(f'res{j}_norm'))
            j += 1
    sd['final_layer.0.weight'] = _kernel(params['head']['kernel'])
    sd['final_layer.0.bias'] = _t(params['head']['bias'])
    return sd


def state_dict_from_flax(variables, jasper_blocks=None
                         ) -> dict[str, torch.Tensor]:
    """Port ``state_dict`` from a flax Wav2Letter or Jasper variable tree.
    A Jasper tree needs its config's ``jasper_blocks`` (``groups`` decides
    the ``mconv`` indices)."""
    params = variables['params']
    stats = variables.get('batch_stats', {}) or {}
    if params and all(n.startswith('conv1d_') for n in params):
        return _wav2letter(params, stats)
    if 'head' in params and any(n.startswith('block') for n in params):
        if jasper_blocks is None:
            raise ValueError('a Jasper variable tree needs jasper_blocks (the '
                             'config dicts) for the mconv indices')
        return _jasper(params, stats, jasper_blocks)
    raise ValueError('neither a Wav2Letter (conv1d_* blocks) nor a Jasper '
                     f'(block*, head) variable tree: {sorted(params)[:4]}')
