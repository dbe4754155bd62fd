"""Greedy CTC decoding and string metrics (host side, numpy in, strings out).

Same strings and metrics as ``Decoder`` and ``GreedyDecoder.decode_ids``
of ``wav2letter_pytorch_tpu.decoding.decoder``. Per-character offsets
(word timings) and beam search are not ported yet.
"""

from __future__ import annotations

import numpy as np

from . import levenshtein
from ..data.label_sets import resolve_labels


class Decoder:
    """Label bookkeeping + WER/CER.

    Args:
        labels: list of characters, or a label-set name.
        blank_index: index of the CTC blank.
    """

    def __init__(self, labels, blank_index: int = 0):
        self.labels = resolve_labels(labels)
        self.int_to_char = dict(enumerate(self.labels))
        self.blank_index = blank_index
        # Out-of-range sentinel when the set has no space.
        self.space_index = (self.labels.index(' ') if ' ' in self.labels
                            else len(self.labels))

    def wer(self, s1: str, s2: str) -> int:
        """Word-level edit distance between two space-separated sentences."""
        vocab = {w: i for i, w in enumerate(set(s1.split() + s2.split()))}
        w1 = [vocab[w] for w in s1.split()]
        w2 = [vocab[w] for w in s2.split()]
        return levenshtein.distance(w1, w2)

    def cer(self, s1: str, s2: str) -> int:
        """Character-level edit distance, ignoring spaces."""
        return levenshtein.distance(s1.replace(' ', ''), s2.replace(' ', ''))

    def cer_ratio(self, expected: str, predicted: str):
        """(distance, denominator) pair for corpus-level aggregation."""
        return self.cer(expected, predicted), len(expected.replace(' ', ''))

    def wer_ratio(self, expected: str, predicted: str):
        return self.wer(expected, predicted), len(expected.split())


class GreedyDecoder(Decoder):
    """Argmax decoding: collapse repeats, strip blanks."""

    def process_sequence(self, sequence, size: int) -> str:
        """One argmax id sequence -> string: collapse repeats, drop
        blanks."""
        chars = []
        prev = None
        for i in range(int(size)):
            idx = int(sequence[i])
            if idx != self.blank_index and idx != prev:
                chars.append(' ' if idx == self.space_index
                             else self.int_to_char[idx])
            prev = idx
        return ''.join(chars)

    def decode_ids(self, ids, sizes=None) -> list[str]:
        """Decode argmaxed label ids [B, T] (the argmax runs on the
        device, so only [B, T] ints cross to the host)."""
        ids = np.asarray(ids)
        return [self.process_sequence(
                    ids[b], int(sizes[b]) if sizes is not None
                    else ids.shape[1])
                for b in range(ids.shape[0])]
