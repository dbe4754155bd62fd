"""String metrics (WER/CER/length ratio) and corpus-ratio accumulation.

``string_metrics`` is ``wav2letter_pytorch_tpu.training.metrics.
string_metrics``: per-batch corpus ratios over the unmasked rows of the
decoding of pre-argmaxed ids (a greedy decoder: the port's trainer
argmaxes on the device) or of probabilities (any other decoder), and a
random (reference, decoded) pair printed with probability
``print_decoded_prob``.
"""

from __future__ import annotations

import random

import numpy as np


def string_sums(decoder, outputs, output_lengths, texts, prefix: str,
                batch_mask=None, print_decoded_prob: float = 0.0):
    """The ``RatioAccumulator`` of ``string_metrics``: numerators and
    denominators of every key, zero where no row is real (a rank's rows
    of a global batch can all be padding). ``outputs``: ids [B, T]
    (``decoder.decode_ids``) or probabilities [B, T, V]
    (``decoder.decode``)."""
    outputs, sizes = np.asarray(outputs), np.asarray(output_lengths)
    decoded = (decoder.decode_ids(outputs, sizes) if outputs.ndim == 2
               else decoder.decode(outputs, sizes))
    if texts and random.random() < print_decoded_prob:
        print(f'reference: {texts[0]}')
        print(f'decoded  : {decoded[0]}')
    acc = RatioAccumulator()
    for key in ('cer', 'wer', 'len_ratio'):
        acc.add(f'{prefix}_{key}', 0.0, 0.0)
    for j, expected in enumerate(texts):
        if batch_mask is not None and not batch_mask[j]:
            continue
        acc.add(f'{prefix}_cer', *decoder.cer_ratio(expected, decoded[j]))
        acc.add(f'{prefix}_wer', *decoder.wer_ratio(expected, decoded[j]))
        acc.add(f'{prefix}_len_ratio', len(decoded[j]), len(expected))
    return acc


def string_metrics(decoder, outputs, output_lengths, texts, prefix: str,
                   batch_mask=None, print_decoded_prob: float = 0.0) -> dict:
    """{prefix}_cer / {prefix}_wer / {prefix}_len_ratio of the decoding of
    ``outputs`` (``string_sums``) against ``texts``; rows where
    ``batch_mask`` is 0 (shape padding) are skipped."""
    return string_sums(decoder, outputs, output_lengths, texts, prefix,
                       batch_mask, print_decoded_prob).ratios(floor=1)


class RatioAccumulator:
    """Corpus-level (numerator, denominator) accumulation across batches."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.denoms: dict[str, float] = {}

    def add(self, key: str, num: float, denom: float):
        self.sums[key] = self.sums.get(key, 0.0) + num
        self.denoms[key] = self.denoms.get(key, 0.0) + denom

    def ratios(self, floor: float = 1e-12) -> dict:
        """Each key's sum over its denominator (at least ``floor``)."""
        return {k: self.sums[k] / max(self.denoms[k], floor)
                for k in self.sums}
