"""Manifest dataset + length-bucketed batching (host side, numpy).

Same batching contract as ``wav2letter_pytorch_tpu.data.dataset``: lengths
are quantised into a few buckets, each batch is padded to its bucket edge,
and a short final batch is padded to the full batch size with repeated
samples masked out through ``batch_mask``. Fixed shapes matter less to
PyTorch than to XLA, but they keep the port's batches identical to the
reference's, so the two can be compared batch for batch.

Manifests: CSV with a leading index column (what pandas writes with
``to_csv``, read there with ``index_col=0``) or JSON lines, each with
``audio_filepath`` and ``text`` and optional ``offset``/``duration``
seconds. Only WAV audio is read; a file whose rate differs from the
configured one raises (resampling is not ported).
"""

from __future__ import annotations

import csv
import json
import queue
import threading

import numpy as np

from . import label_sets
from .audio_io import read_wav, wav_info


def read_manifest(path: str) -> list[dict]:
    """Rows of a CSV / JSON-lines manifest as dicts with ``audio_filepath``,
    ``text``, ``offset`` (default 0.0) and ``duration`` (default -1.0)."""
    if path.endswith('.csv'):
        with open(path, newline='') as f:
            reader = csv.reader(f)
            header = next(reader, None) or []
            cols = header[1:]  # the first column is the index
            rows = [dict(zip(cols, r[1:])) for r in reader if r]
    else:
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    out = []
    for r in rows:
        out.append({'audio_filepath': r['audio_filepath'],
                    'text': str(r['text']),
                    'offset': float(r.get('offset') or 0.0),
                    'duration': float(r.get('duration') or -1.0)})
    return out


class ManifestDataset:
    """Audio + transcript samples described by a manifest."""

    def __init__(self, manifest_filepath: str, sample_rate: int, labels):
        self.rows = read_manifest(manifest_filepath)
        self.sample_rate = int(sample_rate)
        self.labels = label_sets.resolve_labels(labels)
        self.labels_map = {c: i for i, c in enumerate(self.labels)}
        if self.rows:
            _, sr = wav_info(self.rows[0]['audio_filepath'])
            if sr != self.sample_rate:
                raise ValueError(f'Expected sample rate {self.sample_rate} '
                                 f'but found {sr} in first file')

    def encode_text(self, text: str) -> list[int]:
        # Drops unmapped characters and index 0, the blank, which never
        # appears in a transcript.
        return [i for i in (self.labels_map.get(ch) for ch in text) if i]

    def __len__(self):
        return len(self.rows)

    def sample_meta(self, index: int):
        """(num_samples, text) without decoding audio, for bucketing."""
        row = self.rows[index]
        if row['duration'] > 0:
            n = int(row['duration'] * self.sample_rate)
        else:
            frames, _ = wav_info(row['audio_filepath'])
            n = frames - int(row['offset'] * self.sample_rate)
        return n, row['text']

    def __getitem__(self, index: int):
        row = self.rows[index]
        audio, _ = read_wav(row['audio_filepath'], row['duration'],
                            row['offset'])
        return (audio, self.encode_text(row['text']), row['audio_filepath'],
                row['text'])


TARGET_MULTIPLE = 16  # targets are zero-padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketBatchLoader:
    """Batches with length-bucketed shapes and a prefetch thread.

    Yields dicts of numpy arrays: ``audio`` [B, T_bucket] f32,
    ``audio_lengths`` [B] i32, ``targets`` [B, S] i32 (zero-padded),
    ``target_lengths`` [B] i32, ``batch_mask`` [B] f32, plus the host-side
    lists ``texts`` and ``paths``.
    """

    def __init__(self, dataset: ManifestDataset, batch_size: int,
                 frame_hop: int, num_buckets: int = 4,
                 max_duration: float | None = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch

        metas = [dataset.sample_meta(i) for i in range(len(dataset))]
        self.lengths = np.array([m[0] for m in metas], dtype=np.int64)
        max_samples = (int(max_duration * dataset.sample_rate)
                       if max_duration else int(self.lengths.max(initial=1)))
        self.lengths = np.minimum(self.lengths, max_samples)

        # Edges at length quantiles, rounded up so that every edge T
        # satisfies T = 7*hop (mod 8*hop): the frame count 1 + T/hop is a
        # multiple of 8 (the JAX loader's rule with a known STFT hop).
        def edge(x):
            target = 7 * frame_hop
            m = 8 * frame_hop
            return ((max(int(x) - target, 0) + m - 1) // m) * m + target
        qs = np.quantile(self.lengths, np.linspace(0, 1, num_buckets + 1)[1:])
        edges = sorted({edge(q) for q in qs})
        # The top edge covers the longest (cap-clipped) sample in the data.
        edges[-1] = max(edge(int(self.lengths.max(initial=1))), edges[-1])
        self.bucket_edges = edges
        self.max_target_len = max(
            (len(dataset.encode_text(m[1])) for m in metas), default=1)

    def _bucket_of(self, length: int) -> int:
        for i, e in enumerate(self.bucket_edges):
            if length <= e:
                return i
        return len(self.bucket_edges) - 1

    def __len__(self):
        return sum(1 for _ in self._batch_indices())

    def _batch_indices(self):
        buckets: dict[int, list[int]] = {}
        for idx in range(len(self.dataset)):
            b = self._bucket_of(int(self.lengths[idx]))
            buckets.setdefault(b, []).append(idx)
            if len(buckets[b]) == self.batch_size:
                yield b, buckets.pop(b)
        for b, rest in sorted(buckets.items()):
            if rest:
                yield b, rest

    def _make_batch(self, bucket: int, indices: list[int]):
        pad_to = self.bucket_edges[bucket]
        n = len(indices)
        B = self.batch_size
        audio = np.zeros((B, pad_to), np.float32)
        audio_lengths = np.ones((B,), np.int32)
        s_max = _round_up(max(self.max_target_len, 1), TARGET_MULTIPLE)
        targets = np.zeros((B, s_max), np.int32)
        target_lengths = np.zeros((B,), np.int32)
        batch_mask = np.zeros((B,), np.float32)
        texts, paths = [], []
        for j, idx in enumerate(indices):
            samples, target, path, text = self.dataset[idx]
            t = min(len(samples), pad_to)
            audio[j, :t] = samples[:t]
            audio_lengths[j] = t
            target = target[:s_max]
            targets[j, :len(target)] = target
            target_lengths[j] = len(target)
            batch_mask[j] = 1.0
            texts.append(text)
            paths.append(path)
        # Short final batch: repeat the last real sample into the padding
        # rows, which batch_mask keeps out of the loss and the metrics.
        for j in range(n, B):
            audio[j] = audio[n - 1]
            audio_lengths[j] = audio_lengths[n - 1]
            targets[j] = targets[n - 1]
            target_lengths[j] = target_lengths[n - 1]
        return dict(audio=audio, audio_lengths=audio_lengths, targets=targets,
                    target_lengths=target_lengths, batch_mask=batch_mask,
                    texts=texts, paths=paths)

    def __iter__(self):
        if self.prefetch <= 0:
            for b, idxs in self._batch_indices():
                yield self._make_batch(b, idxs)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for b, idxs in self._batch_indices():
                    q.put(self._make_batch(b, idxs))
                q.put(stop)
            except BaseException as e:  # re-raised on the consumer side
                q.put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                thread.join()
                raise item
            yield item
        thread.join()
