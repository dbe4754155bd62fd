"""Offline batched greedy evaluation (PyTorch, CUDA).

    python -m wav2letter_pytorch_tpu_torch.evaluate --test-manifest m.jsonl \
        [--weights sd.pt] [--seed N] [--batch-size B] [--device cuda] \
        [--mid-layers N] [model=quartznet] [key=value ...]

Reads a CSV or JSON-lines manifest of WAV files, runs the log-mel frontend
(kernel K1), the model, the masked CTC mean (kernel K2) and the argmax on
the device, greedy-decodes on the host and prints one JSON line
``{"loss", "num_utterances", "cer", "wer"}`` as the JAX package's
``test.py`` does. The model comes from the training config (``config.py``,
the same ``key=value`` overrides as ``train.py``): Wav2Letter-20 by
default, ``model=quartznet`` or ``model=jasper`` for the Jasper family
(kernels K4 and K6), whose eval-mode probabilities are scored as in
``test.py``. ``--weights`` is a ``state_dict`` of that model saved with
``torch.save`` (``weights.state_dict_from_flax`` makes one from a JAX
checkpoint); without it the weights are drawn from ``--seed``. Batches
are bucketed as ``test.py`` buckets them: ``--batch-size`` or the config's
``data.batch_size``, and its ``data.num_length_buckets`` and
``data.max_duration``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .config import BASE, load_config
from .data.dataset import BucketBatchLoader, ManifestDataset
from .data.features import SpectrogramFrontend
from .decoding.decoder import GreedyDecoder
from .runtime import resolve_device
from .training.build import build_frontend, build_labels, build_model
from .training.metrics import RatioAccumulator
from .training.trainer import eval_step, masked_ctc_mean, to_device

__all__ = ['build', 'evaluate', 'eval_step', 'main', 'make_loader',
           'masked_ctc_mean', 'to_device']

LABELS = 'english_lowercase'


def make_loader(manifest: str, batch_size: int, frontend: SpectrogramFrontend,
                labels=LABELS, prefetch: int = 2,
                num_buckets: int = BASE['data']['num_length_buckets'],
                max_duration: float | None = BASE['data']['max_duration']
                ) -> BucketBatchLoader:
    """Length-bucketed batches in manifest order; the defaults are the
    config's ``data`` block (4 buckets, 16.7 s)."""
    ds = ManifestDataset(manifest, frontend.conf.sample_rate, labels)
    return BucketBatchLoader(ds, batch_size, frontend.hop,
                             num_buckets=num_buckets,
                             max_duration=max_duration, prefetch=prefetch)


def eval_config(overrides=(), mid_layers: int | None = None) -> dict:
    """The training config after ``overrides``, manifests left unset.
    ``mid_layers`` sets the depth; without it, and without a
    ``model.mid_layers`` override, Wav2Letter runs all 20 layers and the
    Jasper family its config's depth."""
    overrides = list(overrides)
    cfg = load_config(['data.train_manifest=-', 'data.val_manifest=-',
                       *overrides])
    mcfg = cfg['model']
    if mid_layers is not None:
        mcfg['mid_layers'] = int(mid_layers)
    elif mcfg['name'] == 'wav2letter' and not any(
            o.lstrip('+').startswith('model.mid_layers=') for o in overrides):
        mcfg['mid_layers'] = len(mcfg['layers'])
    return cfg


def build(device: str | torch.device = 'cuda', seed: int = 0,
          weights: str | None = None, mid_layers: int | None = None,
          overrides=(), cfg: dict | None = None):
    """(model, frontend, labels) on ``device``, in eval mode, from ``cfg``,
    or from ``eval_config(overrides, mid_layers)`` without it. Raises if a
    CUDA device is asked for and none is present."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = eval_config(overrides, mid_layers)
    mcfg = cfg['model']
    labels = build_labels(mcfg)
    model = build_model(mcfg, len(labels), seed=seed)
    if weights:
        model.load_state_dict(torch.load(weights, map_location='cpu',
                                         weights_only=True), strict=True)
    model.to(dev).eval()
    frontend = build_frontend(mcfg, dither=0.0, device=dev)
    return model, frontend, labels


def evaluate(model: torch.nn.Module, frontend: SpectrogramFrontend,
             loader: BucketBatchLoader, decoder: GreedyDecoder,
             device: str | torch.device) -> dict:
    """Loss, WER and CER over every batch of ``loader``."""
    dev = resolve_device(device)
    model.eval()
    acc = RatioAccumulator()
    losses = []
    for batch in loader:
        loss, ids, out_lens = eval_step(model, frontend,
                                        to_device(batch, dev))
        losses.append(float(loss))
        decoded = decoder.decode_ids(ids.cpu().numpy(),
                                     out_lens.cpu().numpy())
        for j, expected in enumerate(batch['texts']):
            if not batch['batch_mask'][j]:
                continue
            c, cd = decoder.cer_ratio(expected, decoded[j])
            w, wd = decoder.wer_ratio(expected, decoded[j])
            acc.add('cer', c, cd)
            acc.add('wer', w, wd)
    result = {'loss': float(np.mean(losses)) if losses else None,
              'num_utterances': len(loader.dataset)}
    result.update(acc.ratios())
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Offline greedy evaluation (PyTorch)')
    parser.add_argument('--test-manifest', required=True)
    parser.add_argument('--weights', default='',
                        help='state_dict saved with torch.save; default: '
                             'weights drawn from --seed')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch-size', type=int, default=None,
                        help="default: the config's data.batch_size")
    parser.add_argument('--mid-layers', type=int, default=None,
                        help="blocks before the head (the config's "
                             'model.mid_layers; default: 20 for '
                             "Wav2Letter, the config's own for Jasper)")
    parser.add_argument('--device', default='cuda')
    parser.add_argument('overrides', nargs='*', metavar='key=value',
                        help='training-config overrides, e.g. '
                             'model=quartznet')
    args = parser.parse_args(argv)

    cfg = eval_config(args.overrides, args.mid_layers)
    model, frontend, labels = build(args.device, args.seed, args.weights,
                                    cfg=cfg)
    data = cfg['data']
    loader = make_loader(args.test_manifest,
                         args.batch_size or int(data['batch_size']), frontend,
                         labels, num_buckets=int(data['num_length_buckets']),
                         max_duration=data['max_duration'])
    result = evaluate(model, frontend, loader, GreedyDecoder(labels),
                      args.device)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
