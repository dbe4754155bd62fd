"""Config -> objects: labels, model, frontend, optimizer.

The counterpart of ``wav2letter_pytorch_tpu.training.build``, with the
same ``_target_`` tables: optimizer and scheduler names written for torch
(``torch.optim.SGD``, ``torch.optim.lr_scheduler.ExponentialLR``, ...) or
for the JAX package resolve onto the port's optimizers and schedules.
"""

from __future__ import annotations

import json
import os

import torch

from .. import optim
from ..config import check_supported, parse_value, set_path
from ..data.features import AudioConfig, SpectrogramFrontend
from ..data.label_sets import resolve_labels
from ..models.jasper import Jasper
from ..models.wav2letter import Wav2Letter

_SCHED_TARGETS = {
    'torch.optim.lr_scheduler.ExponentialLR': 'exponential',
    'wav2letter_pytorch_tpu.optim.exponential_lr': 'exponential',
    'torch.optim.lr_scheduler.OneCycleLR': 'one_cycle',
    'wav2letter_pytorch_tpu.optim.one_cycle_lr': 'one_cycle',
}

_OPT_TARGETS = {
    'torch.optim.SGD': 'sgd',
    'wav2letter_pytorch_tpu.optim.sgd': 'sgd',
    'novograd.Novograd': 'novograd',
    'wav2letter_pytorch_tpu.optim.novograd': 'novograd',
    'torch.optim.AdamW': 'adamw',
}


def build_labels(model_cfg) -> list[str]:
    return resolve_labels(model_cfg['labels'])


def _check_layer_specs(layers, required, what):
    """Fail with a config-level message when a layer spec lacks a key."""
    for i, layer in enumerate(layers):
        missing = [k for k in required if k not in layer]
        if missing:
            raise ValueError(f'{what}[{i}] is missing key(s) {missing}; got '
                             f'keys {sorted(layer)}')


def build_model(model_cfg, num_labels: int, seed: int = 0):
    """The config's model (``model.name``: ``wav2letter`` or ``jasper``) on
    the CPU, conv weights drawn by ``model.init_mode`` from ``seed``."""
    name = model_cfg['name']
    mid_layers = int(model_cfg.get('mid_layers', 1))
    init_mode = model_cfg.get('init_mode', 'xavier_uniform')
    gen = torch.Generator().manual_seed(int(seed))
    if name == 'wav2letter':
        _check_layer_specs(model_cfg['layers'],
                           ('output_size', 'kernel_size', 'stride'),
                           'model.layers')
        return Wav2Letter(num_labels, input_size=int(model_cfg['input_size']),
                          layers=[dict(l) for l in model_cfg['layers']],
                          mid_layers=mid_layers, generator=gen,
                          init_mode=init_mode)
    if name == 'jasper':
        _check_layer_specs(model_cfg['jasper_blocks'],
                           ('layer_size', 'kernel_size'),
                           'model.jasper_blocks')
        return Jasper([dict(b) for b in model_cfg['jasper_blocks']],
                      num_labels, input_size=int(model_cfg['input_size']),
                      mid_layers=mid_layers, init_mode=init_mode,
                      remat=bool(model_cfg.get('remat', False)),
                      dropout_default=float(
                          model_cfg.get('dropout_default', 0.0)),
                      generator=gen)
    raise ValueError(f'Unknown model name: {name!r} '
                     "(expected 'wav2letter' or 'jasper')")


def run_config(run_dir: str, overrides=()) -> dict:
    """The ``config.json`` that ``Trainer.fit`` wrote into ``run_dir``,
    after ``key=value`` overrides (``+key=value`` adds a key)."""
    with open(os.path.join(run_dir, 'config.json')) as f:
        cfg = json.load(f)
    for ov in overrides:
        if '=' not in ov:
            raise ValueError(f'Malformed override (need key=value): {ov!r}')
        key, _, val = ov.partition('=')
        set_path(cfg, key.lstrip('+'), parse_value(val),
                 allow_new=key.startswith('+'))
    check_supported(cfg)
    return cfg


def load_run(run_dir: str, overrides=(), average_last: int | None = None,
             seed: int = 0):
    """A training run directory of the port's ``Trainer``, for evaluation:
    ``(cfg, model, labels, step)``.

    ``cfg`` is the run's ``config.json`` after ``overrides``; ``model`` is
    built from it on the CPU and given the newest checkpoint's ``'model'``
    state, or with ``average_last`` > 1 the average of the newest K
    (``checkpoint.average_checkpoints``); ``step`` is that checkpoint's
    step. A run with no checkpoint gives ``step`` None and the model drawn
    from ``seed``. The counterpart of ``wav2letter_pytorch_tpu.training.
    build.load_run``.
    """
    from .checkpoint import Checkpointer, average_checkpoints

    cfg = run_config(run_dir, overrides)
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels), seed=seed)
    ckpt_dir = os.path.join(run_dir, 'checkpoints')
    if not os.path.isdir(ckpt_dir):
        return cfg, model, labels, None
    ckpt = Checkpointer(ckpt_dir)
    if ckpt.latest_step() is None:
        return cfg, model, labels, None
    if average_last and average_last > 1:
        state = average_checkpoints(ckpt, average_last)
    else:
        state = ckpt.restore()
    model.load_state_dict(state['model'], strict=True)
    return cfg, model, labels, int(state['step'])


def build_frontend(model_cfg, dither: float | None = None,
                   device='cpu') -> SpectrogramFrontend:
    ac = model_cfg['audio_conf']
    conf = AudioConfig(sample_rate=int(ac['sample_rate']),
                       window_size=float(ac['window_size']),
                       window_stride=float(ac['window_stride']),
                       window=ac.get('window', 'hamming'))
    kwargs = {} if dither is None else {'dither': dither}
    return SpectrogramFrontend(conf, n_mels=int(model_cfg['input_size']),
                               device=device, **kwargs)


def build_optimizer(params, model_cfg, steps_per_epoch: int,
                    total_steps: int):
    """``(torch optimizer, schedule)`` from the config. ``schedule`` maps
    an update count (0 for the first update) to the learning rate, which
    the trainer sets on the optimizer before each update."""
    opt_cfg = dict(model_cfg['optimizer'])
    sched_cfg = dict(model_cfg.get('scheduler') or {})
    opt_target = opt_cfg.pop('_target_')
    kind = _OPT_TARGETS.get(opt_target)
    if kind is None:
        raise ValueError(f'Unknown optimizer _target_: {opt_target!r}')
    base_lr = float(opt_cfg.pop('lr'))
    sched_kind = None
    if sched_cfg:
        sched_target = sched_cfg.pop('_target_')
        sched_kind = _SCHED_TARGETS.get(sched_target)
        if sched_kind is None:
            raise ValueError(f'Unknown scheduler _target_: {sched_target!r}')

    if sched_kind == 'exponential':
        schedule = optim.exponential_lr(base_lr, float(sched_cfg['gamma']),
                                        steps_per_epoch=steps_per_epoch)
    elif sched_kind == 'one_cycle':
        schedule = optim.one_cycle_lr(
            float(sched_cfg.get('max_lr', base_lr)),
            total_steps=int(sched_cfg.get('total_steps') or total_steps))
    else:
        schedule = optim.constant_lr(base_lr)

    lr0 = schedule(0)
    if kind == 'sgd':
        opt = torch.optim.SGD(
            params, lr=lr0, momentum=float(opt_cfg.get('momentum', 0.0)),
            nesterov=bool(opt_cfg.get('nesterov', False)),
            weight_decay=float(opt_cfg.get('weight_decay', 0.0)))
    elif kind == 'novograd':
        opt = optim.Novograd(
            params, lr=lr0, betas=tuple(opt_cfg.get('betas', (0.95, 0.0))),
            eps=float(opt_cfg.get('eps', 1e-8)),
            weight_decay=float(opt_cfg.get('weight_decay', 0.0)),
            grad_averaging=bool(opt_cfg.get('grad_averaging', False)),
            amsgrad=bool(opt_cfg.get('amsgrad', False)))
    else:
        opt = torch.optim.AdamW(
            params, lr=lr0,
            weight_decay=float(opt_cfg.get('weight_decay', 0.01)))
    return opt, schedule
