"""String metrics (WER/CER/length ratio) and corpus-ratio accumulation.

``string_metrics`` is ``wav2letter_pytorch_tpu.training.metrics.
string_metrics`` for pre-argmaxed ids (the port's trainer argmaxes on the
device): per-batch corpus ratios over the unmasked rows, and a random
(reference, decoded) pair printed with probability
``print_decoded_prob``.
"""

from __future__ import annotations

import random

import numpy as np


def string_metrics(decoder, ids, output_lengths, texts, prefix: str,
                   batch_mask=None, print_decoded_prob: float = 0.0) -> dict:
    """{prefix}_cer / {prefix}_wer / {prefix}_len_ratio of the greedy
    decoding of ``ids`` [B, T] against ``texts``; rows where
    ``batch_mask`` is 0 (shape padding) are skipped."""
    decoded = decoder.decode_ids(np.asarray(ids), np.asarray(output_lengths))
    if texts and random.random() < print_decoded_prob:
        print(f'reference: {texts[0]}')
        print(f'decoded  : {decoded[0]}')
    acc = RatioAccumulator()
    for j, expected in enumerate(texts):
        if batch_mask is not None and not batch_mask[j]:
            continue
        acc.add(f'{prefix}_cer', *decoder.cer_ratio(expected, decoded[j]))
        acc.add(f'{prefix}_wer', *decoder.wer_ratio(expected, decoded[j]))
        acc.add(f'{prefix}_len_ratio', len(decoded[j]), len(expected))
    return {k: acc.sums.get(k, 0) / max(acc.denoms.get(k, 0), 1)
            for k in (f'{prefix}_cer', f'{prefix}_wer',
                      f'{prefix}_len_ratio')}


class RatioAccumulator:
    """Corpus-level (numerator, denominator) accumulation across batches."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.denoms: dict[str, float] = {}

    def add(self, key: str, num: float, denom: float):
        self.sums[key] = self.sums.get(key, 0.0) + num
        self.denoms[key] = self.denoms.get(key, 0.0) + denom

    def ratios(self) -> dict:
        return {k: self.sums[k] / max(self.denoms[k], 1e-12)
                for k in self.sums}
