"""The training configuration, as Python dicts, with command-line overrides.

The defaults are the JAX package's ``configs/``: ``config.yaml``'s
``data``, ``model`` and ``trainer`` blocks composed with
``model/wav2letter.yaml``, ``audio/standard_16k.yaml`` and
``optimizer/exp_lr_optimizer.yaml``; ``model/jasper.yaml`` and
``model/quartznet.yaml`` are the other model group entries. Overrides, as
on that package's command line:

* ``a.b=value`` sets an existing key to a scalar (``null``, ``true``,
  ``false``, an int, a float or a string); list items are addressed by
  index (``model.layers.0.output_size=24``);
* ``+a.b=value`` adds a key (creating the maps on its path);
* ``optimizer=<name>`` / ``audio=<name>`` / ``model=<name>`` swap a group
  (``model=wav2letter|jasper|quartznet``).

List and map values (``[...]``, ``{...}``) are not parsed. ``${a.b}``
values are resolved after the overrides. Keys of the JAX package that
steer TPU-only mechanisms, or features the port does not have, raise when
set to anything but their default (``check_supported``): they are never
quietly ignored.
"""

from __future__ import annotations

import copy
import re

MISSING = '???'

WAV2LETTER_MODEL = {
    'name': 'wav2letter',
    'mid_layers': 1,
    'layers': [
        {'output_size': w, 'kernel_size': k, 'stride': s, 'dilation': d,
         'dropout': p}
        for w, k, s, d, p in (
            (256, 11, 2, 1, 0.2), (256, 11, 1, 1, 0.2), (256, 11, 1, 1, 0.2),
            (256, 11, 1, 1, 0.2), (384, 13, 1, 1, 0.2), (384, 13, 1, 1, 0.2),
            (384, 13, 1, 1, 0.2), (512, 17, 1, 1, 0.2), (512, 17, 1, 1, 0.2),
            (512, 17, 1, 1, 0.2), (640, 21, 1, 1, 0.3), (640, 21, 1, 1, 0.3),
            (640, 21, 1, 1, 0.3), (768, 25, 1, 1, 0.3), (768, 25, 1, 1, 0.3),
            (768, 25, 1, 1, 0.3), (896, 29, 1, 2, 0.4), (896, 29, 1, 2, 0.4),
            (896, 29, 1, 2, 0.4), (1024, 1, 1, 1, 0.4))],
}


def _jasper_block(layer_size, kernel_size, **kw):
    return {'layer_size': layer_size, 'kernel_size': kernel_size, **kw}


# configs/model/jasper.yaml: the 15-block separable Jasper encoder.
JASPER_MODEL = {
    'name': 'jasper',
    'mid_layers': 1,
    'jasper_blocks': (
        [_jasper_block(256, 32, stride=2, residual=False, separable=True)]
        + [_jasper_block(256, k, stride=1, residual=True, separable=True)
           for k in (32, 32, 32, 38, 38, 38)]
        + [_jasper_block(512, k, stride=1, residual=True, separable=True)
           for k in (50, 50, 50, 62, 62, 62, 74)]
        + [_jasper_block(1024, 1, stride=1, residual=False,
                         separable=False)]),
    'remat': False,
}

# configs/model/quartznet.yaml: QuartzNet-15x5 (arXiv:1910.10261), C1,
# B1-B5 (3 blocks each, R=5), C2, C3.
QUARTZNET_MODEL = {
    'name': 'jasper',
    'mid_layers': 18,
    'jasper_blocks': (
        [_jasper_block(256, 33, stride=2, residual=False, separable=True)]
        + [_jasper_block(w, k, repeat=5, residual=True, separable=True)
           for w, k in ((256, 33), (256, 39), (512, 51), (512, 63),
                        (512, 75)) for _ in range(3)]
        + [_jasper_block(512, 87, dilation=2, residual=False,
                         separable=True),
           _jasper_block(1024, 1, stride=1, residual=False,
                         separable=False)]),
    'remat': False,
}

MODELS = {'wav2letter': WAV2LETTER_MODEL, 'jasper': JASPER_MODEL,
          'quartznet': QUARTZNET_MODEL}

AUDIO = {
    'standard_16k': {'window': 'hamming', 'window_size': 0.02,
                     'window_stride': 0.01, 'sample_rate': 16000,
                     'resample': False},
    'standard_8k': {'window': 'hamming', 'window_size': 0.02,
                    'window_stride': 0.01, 'sample_rate': 8000,
                    'resample': False},
}

OPTIMIZERS = {
    'exp_lr_optimizer': {
        'optimizer': {'_target_': 'torch.optim.SGD', 'lr': 1e-5,
                      'momentum': 0.9, 'nesterov': True,
                      'weight_decay': 1e-5},
        'scheduler': {'_target_': 'torch.optim.lr_scheduler.ExponentialLR',
                      'gamma': 0.999},
    },
    'novograd': {
        'optimizer': {'_target_': 'novograd.Novograd', 'lr': 1e-2,
                      'betas': [0.95, 0.5], 'weight_decay': 1e-3},
        'scheduler': {'_target_': 'torch.optim.lr_scheduler.ExponentialLR',
                      'gamma': 0.999},
    },
    'one_cycle': {
        'optimizer': {'_target_': 'torch.optim.SGD', 'lr': 1e-3,
                      'momentum': 0.9, 'nesterov': True,
                      'weight_decay': 1e-5},
        'scheduler': {'_target_': 'torch.optim.lr_scheduler.OneCycleLR',
                      'max_lr': 1e-3},
    },
}

BASE = {
    'data': {
        'train_manifest': MISSING, 'val_manifest': MISSING,
        'batch_size': 4,
        'mel_spec': '${model.input_size}',
        'audio_conf': '${model.audio_conf}',
        'num_length_buckets': 4, 'max_duration': 16.7, 'shuffle': True,
        'prefetch': 2, 'cache_audio': False, 'audio_dtype': 'float32',
        'augment': None,
    },
    'model': {
        'input_size': 64, 'compute_dtype': 'f32', 'padding_mode': 'reflect',
        'stft_method': 'auto', 'feature_type': 'logmel',
        'init_mode': 'xavier_uniform', 'n_mfcc': None,
        'labels': 'english_lowercase', 'print_decoded_prob': 0,
        'decoder': {'_target_': 'wav2letter_pytorch_tpu.decoding.'
                                'GreedyDecoder',
                    'labels': '${model.labels}'},
    },
    'trainer': {
        'default_root_dir': '.', 'max_epochs': 5, 'max_steps': None,
        'seed': 0, 'log_every_n_steps': 10, 'steps_per_dispatch': 1,
        'device_cache': False, 'string_metrics_interval': 1,
        'string_metrics_flush': 8, 'val_every_n_epochs': 1,
        'ctc_impl': 'auto', 'prng_impl': 'rbg', 'gradient_clip_val': None,
        'accumulate_grad_batches': 1,
        'checkpoint': {'every_n_epochs': 1, 'keep_last': 3},
        'preempt_signal': 'SIGTERM', 'host_rss_budget_gb': None,
        'preempt_sync_every': 25,
        'mesh': {'data': -1, 'seq': 1, 'model': 1},
    },
}

DEFAULT_GROUPS = {'audio': 'standard_16k', 'optimizer': 'exp_lr_optimizer',
                  'model': 'wav2letter'}

# Keys the port does not act on, with the only value it accepts: the TPU
# package's dispatch, device-cache, host-memory, PRNG, mesh, multi-host and
# kernel-selection knobs, and features not ported (yet).
UNSUPPORTED = {
    'trainer.steps_per_dispatch': 1,
    'trainer.device_cache': False,
    'trainer.host_rss_budget_gb': None,
    'trainer.prng_impl': 'rbg',
    'trainer.preempt_sync_every': 25,
    'trainer.ctc_impl': 'auto',
    'trainer.mesh.data': -1,
    'trainer.mesh.seq': 1,
    'trainer.mesh.model': 1,
    'model.stft_method': 'auto',
    'model.padding_mode': 'reflect',
    'model.compute_dtype': 'f32',
    'model.feature_type': 'logmel',
    'model.n_mfcc': None,
    'model.audio_conf.resample': False,
    'data.cache_audio': False,
    'data.audio_dtype': 'float32',
}
SUPPORTED_DECODERS = ('wav2letter_pytorch_tpu.decoding.GreedyDecoder',
                      'decoder.GreedyDecoder')

_INTERP = re.compile(r'^\$\{([^}]+)\}$')


def parse_value(text: str):
    """A scalar override value: null/true/false, int, float or string."""
    low = text.strip().lower()
    if low in ('null', 'none', '~', ''):
        return None
    if low in ('true', 'false'):
        return low == 'true'
    if text.strip()[:1] in ('[', '{'):
        raise ValueError(f'list and map override values are not supported: '
                         f'{text!r} (set items by path, e.g. '
                         'model.layers.0.output_size=24)')
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in '\'"':
        return text[1:-1]
    return text


def _child(node, part: str, dotted: str):
    if isinstance(node, list):
        try:
            return node[int(part)]
        except (ValueError, IndexError) as e:
            raise KeyError(f'Override path {dotted!r}: no item {part!r}') \
                from e
    return node[part]


def set_path(cfg: dict, dotted: str, value, allow_new: bool = False):
    """Set ``a.b.c`` in ``cfg``; a key must exist unless ``allow_new``."""
    parts = dotted.split('.')
    node = cfg
    for p in parts[:-1]:
        if isinstance(node, dict) and not isinstance(node.get(p),
                                                     (dict, list)):
            if not allow_new:
                raise KeyError(f'Override path {dotted!r}: unknown key {p!r} '
                               '(prefix with + to add new keys)')
            node[p] = {}
        node = _child(node, p, dotted)
    last = parts[-1]
    if isinstance(node, list):
        _child(node, last, dotted)
        node[int(last)] = value
        return
    if not allow_new and last not in node:
        raise KeyError(f'Override {dotted!r} sets a key that does not exist '
                       '(prefix with + to add new keys)')
    node[last] = value


def get_path(cfg: dict, dotted: str):
    node = cfg
    for p in dotted.split('.'):
        node = _child(node, p, dotted)
    return node


def _resolve(cfg: dict) -> dict:
    def resolve(value, seen=()):
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        m = _INTERP.match(value) if isinstance(value, str) else None
        if not m:
            return value
        if m.group(1) in seen:
            raise ValueError(f'Interpolation cycle at ${{{m.group(1)}}}')
        return resolve(get_path(cfg, m.group(1)), seen + (m.group(1),))
    return resolve(cfg)


def _missing(node, prefix='') -> list[str]:
    if isinstance(node, dict):
        return [m for k, v in node.items() for m in _missing(v, f'{prefix}{k}.')]
    if isinstance(node, list):
        return [m for i, v in enumerate(node)
                for m in _missing(v, f'{prefix}{i}.')]
    return [prefix[:-1]] if node == MISSING else []


def load_config(overrides=(), require_complete: bool = True) -> dict:
    """The composed config after ``overrides`` (a list of strings)."""
    groups = dict(DEFAULT_GROUPS)
    values = []
    for ov in overrides:
        if '=' not in ov:
            raise ValueError(f'Malformed override (need key=value): {ov!r}')
        key, _, val = ov.partition('=')
        if key.lstrip('+') in groups:
            groups[key.lstrip('+')] = val
        else:
            values.append((key, val))
    for group, table in (('audio', AUDIO), ('optimizer', OPTIMIZERS),
                         ('model', MODELS)):
        if groups[group] not in table:
            raise ValueError(f'No config {groups[group]!r} in group '
                             f'{group!r}; available: {sorted(table)}')
    cfg = copy.deepcopy(BASE)
    cfg['model'].update(copy.deepcopy(MODELS[groups['model']]))
    cfg['model']['audio_conf'] = copy.deepcopy(AUDIO[groups['audio']])
    cfg['model'].update(copy.deepcopy(OPTIMIZERS[groups['optimizer']]))
    for key, val in values:
        set_path(cfg, key.lstrip('+'), parse_value(val),
                 allow_new=key.startswith('+'))
    cfg = _resolve(cfg)
    if require_complete:
        missing = _missing(cfg)
        if missing:
            raise ValueError('Missing mandatory config values (set them on '
                             f'the command line): {missing}')
    check_supported(cfg)
    return cfg


def check_supported(cfg: dict) -> None:
    """Raise if ``cfg`` asks for something the port does not do."""
    for key, default in UNSUPPORTED.items():
        try:
            value = get_path(cfg, key)
        except KeyError:
            continue
        if value != default:
            raise ValueError(f'{key}={value!r} is not supported by the '
                             f'PyTorch port (only {default!r})')
    target = cfg['model']['decoder'].get('_target_')
    if target not in SUPPORTED_DECODERS:
        raise ValueError(f'model.decoder._target_={target!r} is not ported: '
                         'training-time validation decodes greedily (beam '
                         'search with an LM is evaluate.py --lm-path / '
                         '--beam-search-params)')
