"""Training entry point (PyTorch, CUDA).

    python -m wav2letter_pytorch_tpu_torch.train \
        data.train_manifest=train.jsonl data.val_manifest=val.jsonl \
        [model.mid_layers=20] [optimizer=novograd] [--resume] [--cfg] \
        [--device cuda | --cpu]

    torchrun --nproc-per-node N -m wav2letter_pytorch_tpu_torch.train \
        ... trainer.mesh.data=N      # data parallel over N GPUs

    torchrun --nproc-per-node N*M -m wav2letter_pytorch_tpu_torch.train \
        ... trainer.mesh.data=N trainer.mesh.model=M   # and tensor parallel

    torchrun --nproc-per-node N*M*Q -m wav2letter_pytorch_tpu_torch.train \
        ... trainer.mesh.data=N trainer.mesh.model=M trainer.mesh.seq=Q

The counterpart of the JAX package's ``train.py``: dotted ``key=value``
overrides and group swaps (``config.py``), WAV or FLAC manifests (CSV or
JSON lines; ``data.cache_audio``, ``data.audio_dtype`` and
``model.audio_conf.resample`` as there), and ``Trainer.fit`` with
validation (scored by ``model.decoder`` through ``build_decoder``:
greedy, or a beam search on the host or on the device), checkpoints
under ``<trainer.default_root_dir>/checkpoints`` and ``metrics.csv``
beside them. ``--resume`` continues from the latest checkpoint; ``--cfg`` prints
the composed config as JSON and exits. The device defaults to ``cuda``
and raises when no card is present; ``--cpu`` is ``--device cpu``.

Under torchrun (``WORLD_SIZE`` in the environment) every process joins
the group (``parallel.init_distributed``: NCCL on ``cuda:LOCAL_RANK``,
gloo on the CPU) and trains on its rows of each global batch of
``data.batch_size`` (``BucketBatchLoader(row_shard=...)``), which must
divide by the world size: the same math as the JAX package's
``trainer.mesh.data=N`` step. ``trainer.mesh.data`` -1 means the world
size; another value must equal it.

``trainer.mesh.model=M`` > 1 adds tensor parallelism (``parallel/tp.py``):
the world is ``data x model`` ranks (data -1 means ``WORLD_SIZE //
model``), M ranks share each replica's channel shards and its rows of the
global batch, and the checkpoints keep the model=1 layout. It needs
torchrun: without a process group it stops rather than train unsharded.

``trainer.mesh.seq=Q`` > 1 adds sequence parallelism (``parallel/sp.py``):
the world is ``data x model x seq`` ranks (data -1 means ``WORLD_SIZE //
(model * seq)``), the Q ranks of a replica's seq group hold its rows and
each its range of every activation's frames. Like ``mesh.model`` it
needs torchrun.
"""

from __future__ import annotations

import json
import os
import sys

from . import parallel
from .config import load_config
from .data.dataset import BucketBatchLoader, ManifestDataset, resample_flag
from .runtime import resolve_device
from .training.build import (build_decoder, build_frontend, build_labels,
                             build_model, build_optimizer)
from .training.trainer import Trainer


def get_data_loaders(labels, data_cfg, seed: int = 0, row_shard=(0, 1)):
    """(train, val) loaders. The train loader shuffles epoch ``e`` with
    ``np.random.default_rng(seed + e)``, as the JAX loader does; the JAX
    entry point passes no seed, so the two orders agree at seed 0.
    ``row_shard=(rank, world)``: each batch is this rank's rows of the
    global batch."""
    ac = data_cfg['audio_conf']
    sr = int(ac['sample_rate'])
    kwargs = dict(frame_hop=int(sr * ac['window_stride']),
                  num_buckets=int(data_cfg.get('num_length_buckets', 4)),
                  max_duration=data_cfg.get('max_duration'),
                  prefetch=int(data_cfg.get('prefetch', 2)),
                  row_shard=row_shard)
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


def data_world(mesh_data, mesh_model=1, mesh_seq=1) -> int:
    """The data extent ``trainer.mesh.data`` x ``trainer.mesh.model`` x
    ``trainer.mesh.seq`` asks for, checked against torchrun's
    ``WORLD_SIZE`` (1 without torchrun): ``WORLD_SIZE`` must be data x
    model x seq; data -1 means ``WORLD_SIZE // (model * seq)``. A grid
    that does not fill the world stops with the JAX package's text."""
    launched = int(os.environ.get('WORLD_SIZE', '1'))
    model, seq = int(mesh_model or 1), int(mesh_seq or 1)
    want = int(mesh_data if mesh_data is not None else -1)
    data = launched // (model * seq) if want == -1 else want
    if 'WORLD_SIZE' not in os.environ and (want not in (-1, 1)
                                           or model * seq > 1):
        raise SystemExit(
            f'trainer.mesh.data={want} trainer.mesh.model={model} '
            f'trainer.mesh.seq={seq}: launch one process a device with '
            f'torchrun --nproc-per-node {max(data, 1) * model * seq} -m '
            'wav2letter_pytorch_tpu_torch.train ...')
    if data < 1 or data * model * seq != launched:
        raise SystemExit(
            f'trainer.mesh.data={want} x trainer.mesh.model={model} x '
            f'trainer.mesh.seq={seq} but torchrun started WORLD_SIZE='
            f'{launched} processes: Requested {data}x{model}x{seq} (data x '
            f'model x seq) devices, only {launched} visible')
    return data


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
        elif arg == '--cpu':
            device = 'cpu'
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

    mesh_cfg = cfg['trainer'].get('mesh', {})
    model_size = int(mesh_cfg.get('model', 1) or 1)
    seq_size = int(mesh_cfg.get('seq', 1) or 1)
    world = data_world(mesh_cfg.get('data'), model_size, seq_size)
    if 'WORLD_SIZE' in os.environ:
        dev = parallel.init_distributed(device, model=model_size,
                                        seq=seq_size)
    else:
        dev = resolve_device(device)
    labels = build_labels(cfg['model'])
    seed = int(cfg['trainer'].get('seed', 0))
    train_loader, val_loader = get_data_loaders(
        labels, cfg['data'], seed, row_shard=(parallel.data_rank(), world))
    model = build_model(cfg['model'], len(labels), seed=seed).to(dev)
    frontend = build_frontend(cfg['model'], device=dev)
    steps_per_epoch = len(train_loader)
    total = steps_per_epoch * int(cfg['trainer'].get('max_epochs', 5))
    optimizer, schedule = build_optimizer(model.parameters(), cfg['model'],
                                          steps_per_epoch, total)
    trainer = Trainer(cfg, model, frontend, optimizer, schedule,
                      build_decoder(cfg['model'], labels, device=dev),
                      device=dev)
    try:
        trainer.fit(train_loader, val_loader, resume='--resume' in flags)
    finally:
        trainer.close()
        dump_launches()
    return 0


def dump_launches() -> None:
    """With ``W2L_LAUNCHES_JSON`` set, write each kernel wrapper's launch
    count (``<wrapper>.launches``) there as JSON, suffixed by the rank
    under a process group: launch checks of a process started by
    torchrun read it."""
    path = os.environ.get('W2L_LAUNCHES_JSON')
    if not path:
        return
    from .ops.ctc_kernel import ctc_alpha, ctc_beta
    from .ops.depthwise import depthwise_fwd, depthwise_wgrad
    from .ops.sep_conv import sep_bwd, sep_fwd
    from .ops.stft_mel import stft_mel_log
    counts = {fn.__name__: fn.launches for fn in (
        stft_mel_log, ctc_alpha, ctc_beta, depthwise_fwd, depthwise_wgrad,
        sep_fwd, sep_bwd)}
    if parallel.distributed():
        path = f'{path}.{parallel.rank()}'
    with open(path, 'w') as f:
        json.dump(counts, f)


if __name__ == '__main__':
    raise SystemExit(main())
