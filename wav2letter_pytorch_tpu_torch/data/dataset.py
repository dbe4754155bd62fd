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
seconds. Audio is WAV or FLAC (``audio_io.read_audio``). A first file
whose rate differs from the configured one raises, unless ``resample``
converts every file to that rate on read (``resample.py``).
"""

from __future__ import annotations

import csv
import json
import queue
import threading

import numpy as np

from ..parallel.mesh import check_divisible
from . import label_sets
from .audio_io import audio_info, read_audio
from .resample import resample, resample_ratio

AUDIO_DTYPES = ('float32', 'int16')


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


def resample_flag(audio_conf) -> bool:
    """``audio_conf.resample`` of a config or an artifact (off if unset)."""
    return bool((audio_conf or {}).get('resample', False))


class ManifestDataset:
    """Audio + transcript samples described by a manifest.

    ``resample``: files at another rate are resampled to ``sample_rate``
    on read (the JAX package's ``audio_conf.resample``); without it the
    first file's rate is checked against ``sample_rate``.

    ``cache_audio``: each decoded (and resampled) waveform is kept in host
    memory after its first read, so later epochs decode nothing.

    ``audio_dtype='int16'``: samples are kept, and batched, as 16-bit PCM,
    ``clip(rint(x * 32768))``: exact for 16-bit sources, whose samples are
    multiples of 1/32768; finer or resampled audio is rounded to 16 bits.
    The frontend turns them back into ``x / 32768`` before dither.
    """

    def __init__(self, manifest_filepath: str, sample_rate: int, labels,
                 resample: bool = False, cache_audio: bool = False,
                 audio_dtype: str = 'float32'):
        self.rows = read_manifest(manifest_filepath)
        self.sample_rate = int(sample_rate)
        self.resample = bool(resample)
        self.labels = label_sets.resolve_labels(labels)
        self.labels_map = {c: i for i, c in enumerate(self.labels)}
        if audio_dtype not in AUDIO_DTYPES:
            raise ValueError(f'audio_dtype must be float32 or int16, '
                             f'got {audio_dtype!r}')
        self.audio_dtype = np.dtype(audio_dtype)
        self._audio_cache: dict[int, np.ndarray] | None = (
            {} if cache_audio else None)
        if self.rows and not self.resample:
            _, sr = audio_info(self.rows[0]['audio_filepath'])
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
        """(num_samples, text) without decoding audio, for bucketing; with
        ``resample``, the exact length after resampling,
        ``ceil(n * up / down)``."""
        row = self.rows[index]
        if row['duration'] > 0:
            n = int(row['duration'] * self.sample_rate)
        elif self.resample:
            frames, sr = audio_info(row['audio_filepath'])
            up, down = resample_ratio(sr, self.sample_rate)
            n = -(-(frames - int(row['offset'] * sr)) * up // down)
        else:
            frames, _ = audio_info(row['audio_filepath'])
            n = frames - int(row['offset'] * self.sample_rate)
        return n, row['text']

    def __getitem__(self, index: int):
        row = self.rows[index]
        cache = self._audio_cache
        audio = cache.get(index) if cache is not None else None
        if audio is None:
            audio, sr = read_audio(row['audio_filepath'], row['duration'],
                                   row['offset'])
            if self.resample and sr != self.sample_rate:
                audio = resample(audio, sr, self.sample_rate)
            if self.audio_dtype == np.int16:
                audio = np.clip(np.rint(audio * 32768.0),
                                -32768, 32767).astype(np.int16)
            if cache is not None:
                cache[index] = audio
        return (audio, self.encode_text(row['text']), row['audio_filepath'],
                row['text'])


TARGET_MULTIPLE = 16  # targets are zero-padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketBatchLoader:
    """Batches with length-bucketed shapes and a prefetch thread.

    Yields dicts of numpy arrays: ``audio`` [B, T_bucket] in the
    dataset's ``audio_dtype`` (f32, or int16 PCM),
    ``audio_lengths`` [B] i32, ``targets`` [B, S] i32 (zero-padded),
    ``target_lengths`` [B] i32, ``batch_mask`` [B] f32, plus the host-side
    lists ``texts`` and ``paths``.

    With ``shuffle``, epoch ``e`` visits the samples in the order
    ``np.random.default_rng(seed + e).shuffle`` gives, as the JAX loader
    does, so both see the same batches (``tests/test_torch_data.py``).
    ``epoch`` is the epoch the next ``iter()`` runs (each ``iter()``
    advances it); a resumed run sets it. ``drop_last`` drops each bucket's
    short final batch.

    Data parallelism, two ways:

    * ``shard_id`` / ``num_shards``, the JAX package's multi-host API:
      this loader walks ``order[shard_id::num_shards]`` of the epoch's
      order, ``batch_size`` being the per-host batch;
    * ``row_shard=(rank, world)``, what ``train.py`` uses: every rank
      walks the same global batches (``batch_size`` rows, the same
      buckets and padding) and builds only rows ``[rank * b, (rank + 1) *
      b)`` of each, ``b = batch_size / world``, decoding only the samples
      of those rows. A ``world``-rank run then sees exactly the batches of
      one process, and every rank has the same number of batches.
    """

    def __init__(self, dataset: ManifestDataset, batch_size: int,
                 frame_hop: int, num_buckets: int = 4,
                 max_duration: float | None = None, prefetch: int = 2,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, shard_id: int = 0,
                 num_shards: int = 1, row_shard: tuple = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        self.row_rank, self.row_world = (int(v) for v in row_shard)
        self.rows = check_divisible(batch_size, self.row_world)
        self.epoch = 0

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
        """Batch count of the first epoch's order (metadata only)."""
        return sum(1 for _ in self._batch_indices(0))

    def _batch_indices(self, epoch: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
        buckets: dict[int, list[int]] = {}
        for idx in order:
            b = self._bucket_of(int(self.lengths[idx]))
            buckets.setdefault(b, []).append(int(idx))
            if len(buckets[b]) == self.batch_size:
                yield b, buckets.pop(b)
        for b, rest in sorted(buckets.items()):
            if rest and not self.drop_last:
                yield b, rest

    def _make_batch(self, bucket: int, indices: list[int]):
        """Rows ``[lo, lo + rows)`` of the global batch of ``indices``."""
        pad_to = self.bucket_edges[bucket]
        n = len(indices)
        B = self.rows
        lo = self.row_rank * B
        audio = np.zeros((B, pad_to), self.dataset.audio_dtype)
        audio_lengths = np.ones((B,), np.int32)
        s_max = _round_up(max(self.max_target_len, 1), TARGET_MULTIPLE)
        targets = np.zeros((B, s_max), np.int32)
        target_lengths = np.zeros((B,), np.int32)
        batch_mask = np.zeros((B,), np.float32)
        texts, paths = [], []
        # Short final batch: the padding rows repeat the last real sample;
        # batch_mask keeps them out of the loss and the metrics.
        for j in range(B):
            if lo + j >= n and j > 0:
                audio[j:] = audio[j - 1]
                audio_lengths[j:] = audio_lengths[j - 1]
                targets[j:] = targets[j - 1]
                target_lengths[j:] = target_lengths[j - 1]
                break
            samples, target, path, text = self.dataset[
                indices[min(lo + j, n - 1)]]
            t = min(len(samples), pad_to)
            audio[j, :t] = samples[:t]
            audio_lengths[j] = t
            target = target[:s_max]
            targets[j, :len(target)] = target
            target_lengths[j] = len(target)
            if lo + j < n:
                batch_mask[j] = 1.0
                texts.append(text)
                paths.append(path)
        return dict(audio=audio, audio_lengths=audio_lengths, targets=targets,
                    target_lengths=target_lengths, batch_mask=batch_mask,
                    texts=texts, paths=paths)

    def peek_batch(self):
        """First batch of the upcoming epoch, without advancing ``epoch``
        or starting the prefetch thread; None for an empty loader."""
        for b, idxs in self._batch_indices(self.epoch):
            return self._make_batch(b, idxs)
        return None

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        if self.prefetch <= 0:
            for b, idxs in self._batch_indices(epoch):
                yield self._make_batch(b, idxs)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()

        def worker():
            try:
                for b, idxs in self._batch_indices(epoch):
                    if closed.is_set():
                        return
                    q.put(self._make_batch(b, idxs))
                q.put(stop)
            except BaseException as e:  # re-raised on the consumer side
                q.put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Also on an early close(): unblock the worker and wait for it.
            closed.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
