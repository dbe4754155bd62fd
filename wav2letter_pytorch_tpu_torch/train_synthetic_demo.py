"""Convergence demo: learn a synthetic tone language end to end.

    python -m wav2letter_pytorch_tpu_torch.train_synthetic_demo \
        [--epochs 12] [--n-train 400] [--augment] [--out DIR] \
        [--device cuda]

The counterpart of the JAX package's ``scripts/train_synthetic_demo.py``.
``make_corpus`` writes its "spoken digits" corpus byte for byte (each
letter a tone of its own pitch on a semitone ladder, utterances of 2-4
digit words, ``np.random.default_rng(0)``, WAV files and JSON-lines
manifests); ``main`` trains a 3-layer Wav2Letter on it with NovoGrad
through ``train.main`` (the JAX script's overrides) and scores both
splits through ``evaluate.main``. A working pipeline drives the WER
towards 0; random output sits near 100 %. Prints one JSON line
``{"demo", "train_wer", "train_cer", "val_wer", "val_cer"}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os

import numpy as np

SR = 16000
WORDS = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
         'eight', 'nine']
LETTER_SECONDS = 0.08
GAP_SECONDS = 0.04


def letter_freq(ch: str) -> float:
    if ch == ' ':
        return 0.0
    return 220.0 * 2 ** ((ord(ch) - ord('a')) / 12.0)  # a semitone ladder


def render(text: str, rng) -> np.ndarray:
    chunks = []
    for ch in text:
        n = int(LETTER_SECONDS * SR)
        t = np.arange(n) / SR
        f = letter_freq(ch)
        tone = 0.4 * np.sin(2 * np.pi * f * t) if f else np.zeros(n)
        chunks.append(tone)
        chunks.append(np.zeros(int(GAP_SECONDS * SR)))
    audio = np.concatenate(chunks)
    audio += 0.01 * rng.standard_normal(audio.shape)
    return audio.astype(np.float32)


def make_corpus(root: str, n_train: int = 400, n_val: int = 60) -> dict:
    """Write ``{split}{i}.wav`` and ``{split}.jsonl`` for the train and val
    splits under ``root``; returns ``{'train': path, 'val': path}``."""
    from .data.audio_io import write_wav
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    manifests = {}
    for split, n in (('train', n_train), ('val', n_val)):
        rows = []
        for i in range(n):
            text = ' '.join(rng.choice(WORDS)
                            for _ in range(rng.integers(2, 5)))
            path = os.path.join(root, f'{split}{i}.wav')
            write_wav(path, render(text, rng), SR)
            rows.append({'audio_filepath': path, 'text': text})
        manifest = os.path.join(root, f'{split}.jsonl')
        with open(manifest, 'w') as f:
            f.write('\n'.join(json.dumps(r) for r in rows))
        manifests[split] = manifest
    return manifests


def train_overrides(manifests: dict, run_dir: str, epochs: int,
                    augment: bool = False) -> list:
    """The JAX script's ``train.py`` overrides."""
    return [
        f'data.train_manifest={manifests["train"]}',
        f'data.val_manifest={manifests["val"]}',
        'data.batch_size=16', 'data.num_length_buckets=2',
        'optimizer=novograd', 'model.optimizer.lr=2e-3',
        'model.scheduler.gamma=0.97',
        'model.mid_layers=3',
        'model.layers=[{output_size: 128, kernel_size: 11, stride: 2, '
        'dilation: 1, dropout: 0.1}, {output_size: 128, kernel_size: 11, '
        'stride: 1, dilation: 1, dropout: 0.1}, {output_size: 256, '
        'kernel_size: 13, stride: 1, dilation: 1, dropout: 0.1}]',
        *(['data.augment={spec_augment: {freq_masks: 2, time_masks: 2, '
           'freq_width: 8, time_width: 12}}'] if augment else []),
        f'trainer.max_epochs={epochs}',
        'trainer.string_metrics_interval=20',
        'trainer.log_every_n_steps=20',
        f'trainer.default_root_dir={run_dir}',
    ]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=12)
    parser.add_argument('--n-train', type=int, default=400)
    parser.add_argument('--augment', action='store_true',
                        help='enable SpecAugment during training')
    parser.add_argument('--out', default=os.path.join('runs',
                                                      'w2l_synth_demo'))
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import evaluate as eval_cli
    from . import train as train_cli

    manifests = make_corpus(os.path.join(args.out, 'data'),
                            n_train=args.n_train)
    run_dir = os.path.join(args.out, 'run')
    rc = train_cli.main(train_overrides(manifests, run_dir, args.epochs,
                                        args.augment)
                        + ['--device', args.device])
    if rc != 0:
        raise SystemExit(f'training failed ({rc})')

    # Train-split WER shows fitting capacity; val-split WER shows
    # generalisation.
    results = {'demo': 'synthetic_digits'}
    for split in ('train', 'val'):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_cli.main(['--model-path', run_dir, '--test-manifest',
                           manifests[split], '--device', args.device])
        metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
        results[f'{split}_wer'] = metrics['wer']
        results[f'{split}_cer'] = metrics['cer']
    print(json.dumps(results))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
