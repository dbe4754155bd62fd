"""Training entry point (PyTorch, CUDA).

    python -m wav2letter_pytorch_tpu_torch.train \
        data.train_manifest=train.jsonl data.val_manifest=val.jsonl \
        [model.mid_layers=20] [optimizer=novograd] [--resume] [--cfg] \
        [--device cuda]

The counterpart of the JAX package's ``train.py``: dotted ``key=value``
overrides and group swaps (``config.py``), WAV or FLAC manifests (CSV or
JSON lines; ``data.cache_audio``, ``data.audio_dtype`` and
``model.audio_conf.resample`` as there), and ``Trainer.fit`` with validation, checkpoints under
``<trainer.default_root_dir>/checkpoints`` and ``metrics.csv`` beside
them. ``--resume`` continues from the latest checkpoint; ``--cfg`` prints
the composed config as JSON and exits. The device defaults to ``cuda``
and raises when no card is present.
"""

from __future__ import annotations

import json
import sys

from .config import load_config
from .data.dataset import BucketBatchLoader, ManifestDataset, resample_flag
from .runtime import resolve_device
from .decoding.decoder import GreedyDecoder
from .training.build import (build_frontend, build_labels, build_model,
                             build_optimizer)
from .training.trainer import Trainer


def get_data_loaders(labels, data_cfg, seed: int = 0):
    """(train, val) loaders. The train loader shuffles epoch ``e`` with
    ``np.random.default_rng(seed + e)``, as the JAX loader does; the JAX
    entry point passes no seed, so the two orders agree at seed 0."""
    ac = data_cfg['audio_conf']
    sr = int(ac['sample_rate'])
    kwargs = dict(frame_hop=int(sr * ac['window_stride']),
                  num_buckets=int(data_cfg.get('num_length_buckets', 4)),
                  max_duration=data_cfg.get('max_duration'),
                  prefetch=int(data_cfg.get('prefetch', 2)))
    batch_size = int(data_cfg['batch_size'])
    ds_kwargs = dict(resample=resample_flag(ac),
                     cache_audio=bool(data_cfg.get('cache_audio', False)),
                     audio_dtype=str(data_cfg.get('audio_dtype', 'float32')))
    train = BucketBatchLoader(
        ManifestDataset(data_cfg['train_manifest'], sr, labels, **ds_kwargs),
        batch_size, shuffle=bool(data_cfg.get('shuffle', True)), seed=seed,
        **kwargs)
    val = BucketBatchLoader(
        ManifestDataset(data_cfg['val_manifest'], sr, labels, **ds_kwargs),
        batch_size, shuffle=False, **kwargs)
    return train, val


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = 'cuda'
    rest = []
    it = iter(argv)
    for arg in it:
        if arg == '--device':
            device = next(it, device)
        elif arg.startswith('--device='):
            device = arg.partition('=')[2]
        else:
            rest.append(arg)
    flags = {a for a in rest if a.startswith('--')}
    unknown = flags - {'--resume', '--cfg'}
    if unknown:
        raise SystemExit(f'unknown option(s): {sorted(unknown)}')
    cfg = load_config([a for a in rest if not a.startswith('--')])
    if '--cfg' in flags:
        print(json.dumps(cfg, indent=2))
        return 0

    dev = resolve_device(device)
    labels = build_labels(cfg['model'])
    seed = int(cfg['trainer'].get('seed', 0))
    train_loader, val_loader = get_data_loaders(labels, cfg['data'], seed)
    model = build_model(cfg['model'], len(labels), seed=seed).to(dev)
    frontend = build_frontend(cfg['model'], device=dev)
    steps_per_epoch = len(train_loader)
    total = steps_per_epoch * int(cfg['trainer'].get('max_epochs', 5))
    optimizer, schedule = build_optimizer(model.parameters(), cfg['model'],
                                          steps_per_epoch, total)
    trainer = Trainer(cfg, model, frontend, optimizer, schedule,
                      GreedyDecoder(labels), device=dev)
    try:
        trainer.fit(train_loader, val_loader, resume='--resume' in flags)
    finally:
        trainer.close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
