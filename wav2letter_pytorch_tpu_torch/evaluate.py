"""Offline batched greedy evaluation of Wav2Letter (PyTorch, CUDA).

    python -m wav2letter_pytorch_tpu_torch.evaluate --test-manifest m.jsonl \
        [--weights sd.pt] [--seed N] [--batch-size B] [--device cuda]

Reads a CSV or JSON-lines manifest of WAV files, runs the log-mel frontend
(kernel K1), the Wav2Letter stack, the masked CTC mean (kernel K2) and the
argmax on the device, greedy-decodes on the host and prints one JSON line
``{"loss", "num_utterances", "cer", "wer"}`` as the JAX package's
``test.py`` does. ``--weights`` is a ``state_dict`` saved with
``torch.save`` (``weights.state_dict_from_flax`` makes one from a JAX
checkpoint); without it the weights are drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .data.dataset import BucketBatchLoader, ManifestDataset
from .data.features import AudioConfig, SpectrogramFrontend
from .data.label_sets import resolve_labels
from .decoding.decoder import GreedyDecoder
from .models.wav2letter import WAV2LETTER_LAYERS, Wav2Letter
from .runtime import resolve_device
from .training.metrics import RatioAccumulator
from .training.trainer import eval_step, masked_ctc_mean, to_device

__all__ = ['build', 'evaluate', 'eval_step', 'main', 'make_loader',
           'masked_ctc_mean', 'to_device']

LABELS = 'english_lowercase'
N_MELS = 64
MAX_DURATION = 16.7  # seconds: cap on the padded audio length


def make_loader(manifest: str, batch_size: int, frontend: SpectrogramFrontend,
                labels=LABELS, prefetch: int = 2) -> BucketBatchLoader:
    ds = ManifestDataset(manifest, frontend.conf.sample_rate, labels)
    return BucketBatchLoader(ds, batch_size, frontend.hop,
                             max_duration=MAX_DURATION, prefetch=prefetch)


def build(device: str | torch.device = 'cuda', seed: int = 0,
          weights: str | None = None, mid_layers: int = 20):
    """(model, frontend, labels) on ``device``, in eval mode. Raises if a
    CUDA device is asked for and none is present."""
    dev = resolve_device(device)
    labels = resolve_labels(LABELS)
    gen = torch.Generator().manual_seed(seed)
    model = Wav2Letter(len(labels), input_size=N_MELS,
                       layers=WAV2LETTER_LAYERS, mid_layers=mid_layers,
                       generator=gen)
    if weights:
        model.load_state_dict(torch.load(weights, map_location='cpu',
                                         weights_only=True), strict=True)
    model.to(dev).eval()
    frontend = SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0,
                                   device=dev)
    return model, frontend, labels


def evaluate(model: Wav2Letter, frontend: SpectrogramFrontend,
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
        description='Offline greedy evaluation of Wav2Letter (PyTorch)')
    parser.add_argument('--test-manifest', required=True)
    parser.add_argument('--weights', default='',
                        help='state_dict saved with torch.save; default: '
                             'weights drawn from --seed')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--mid-layers', type=int, default=20,
                        help='conv blocks before the head (the JAX '
                             "config's model.mid_layers)")
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    model, frontend, labels = build(args.device, args.seed, args.weights,
                                    args.mid_layers)
    loader = make_loader(args.test_manifest, args.batch_size, frontend,
                         labels)
    result = evaluate(model, frontend, loader, GreedyDecoder(labels),
                      args.device)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
