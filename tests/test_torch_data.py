"""Port data pipeline, decoder and metrics vs the JAX package.

Same WAV files and manifests (JSON lines, and CSV as pandas writes it)
through both loaders; same id sequences and strings through both decoders.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from wav2letter_pytorch_tpu.data.audio_io import read_wav as jax_read_wav
from wav2letter_pytorch_tpu.data.dataset import \
    BucketBatchLoader as JaxLoader
from wav2letter_pytorch_tpu.data.dataset import \
    ManifestDataset as JaxDataset
from wav2letter_pytorch_tpu.data.label_sets import labels_map as jax_labels
from wav2letter_pytorch_tpu.decoding.decoder import \
    GreedyDecoder as JaxGreedyDecoder
from wav2letter_pytorch_tpu.decoding.levenshtein import _py_distance
from wav2letter_pytorch_tpu.training.metrics import \
    RatioAccumulator as JaxRatioAccumulator
from wav2letter_pytorch_tpu_torch.data.audio_io import read_wav, write_wav
from wav2letter_pytorch_tpu_torch.data.dataset import (BucketBatchLoader,
                                                       ManifestDataset,
                                                       read_manifest)
from wav2letter_pytorch_tpu_torch.data.label_sets import (labels_map,
                                                          resolve_labels)
from wav2letter_pytorch_tpu_torch.decoding import levenshtein
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.training.metrics import RatioAccumulator

torch.set_num_threads(1)

SR = 16000
TEXTS = ['hello world', 'abc', 'the quick brown fox', "it's over",
         'the lazy dog', 'a b c d', 'zz top']


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        n = int(rng.integers(SR // 4, 3 * SR // 2))
        path = tmp_path / f'utt{i}.wav'
        write_wav(str(path), 0.3 * rng.standard_normal(n).astype(np.float32)
                  .clip(-1, 1), SR)
        rows.append({'audio_filepath': str(path), 'text': text})
    jsonl = tmp_path / 'manifest.jsonl'
    jsonl.write_text('\n'.join(json.dumps(r) for r in rows) + '\n')
    csv_path = tmp_path / 'manifest.csv'
    pd.DataFrame(rows).to_csv(csv_path)  # index column, as prepare scripts do
    return jsonl, csv_path, rows


def test_labels_match_jax():
    assert labels_map == jax_labels
    assert len(resolve_labels('english_lowercase')) == 29


def test_wav_roundtrip_and_offsets_match_jax(corpus):
    _, _, rows = corpus
    path = rows[2]['audio_filepath']
    for kw in ({}, {'offset': 0.1, 'duration': 0.2}):
        ours, sr = read_wav(path, **kw)
        ref, ref_sr = jax_read_wav(path, **kw)
        assert sr == ref_sr == SR
        np.testing.assert_array_equal(ours, ref)


def test_csv_and_jsonl_manifests_read_alike(corpus):
    jsonl, csv_path, rows = corpus
    for path in (jsonl, csv_path):
        got = read_manifest(str(path))
        assert [r['audio_filepath'] for r in got] == [
            r['audio_filepath'] for r in rows]
        assert [r['text'] for r in got] == TEXTS
        assert all(r['offset'] == 0.0 and r['duration'] == -1.0 for r in got)


@pytest.mark.parametrize('frame_hop,num_buckets,batch_size',
                         [(160, 4, 2), (80, 3, 3), (160, 1, 4)])
def test_loader_matches_jax_loader(corpus, frame_hop, num_buckets,
                                   batch_size):
    jsonl, csv_path, _ = corpus
    for manifest in (str(jsonl), str(csv_path)):
        ours = BucketBatchLoader(
            ManifestDataset(manifest, SR, 'english_lowercase'), batch_size,
            frame_hop, num_buckets=num_buckets, prefetch=0)
        ref = JaxLoader(
            JaxDataset(manifest, {'sample_rate': SR}, 'english_lowercase'),
            batch_size, num_buckets=num_buckets, frame_hop=frame_hop,
            prefetch=0)
        assert ours.bucket_edges == ref.bucket_edges
        assert all((1 + e // frame_hop) % 8 == 0 for e in ours.bucket_edges)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        assert any(b['batch_mask'].min() == 0 for b in got)  # a short batch
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k


@pytest.mark.parametrize('seed,drop_last', [(0, False), (0, True),
                                            (3, False), (3, True)])
def test_shuffled_epochs_match_jax_loader(corpus, seed, drop_last):
    """Epochs 0..2 shuffled: the same samples in the same batches as the
    JAX loader, peek_batch included (exact: both shuffle with numpy)."""
    jsonl, _, _ = corpus
    ours = BucketBatchLoader(
        ManifestDataset(str(jsonl), SR, 'english_lowercase'), 2, 160,
        num_buckets=2, prefetch=0, shuffle=True, seed=seed,
        drop_last=drop_last)
    ref = JaxLoader(
        JaxDataset(str(jsonl), {'sample_rate': SR}, 'english_lowercase'), 2,
        num_buckets=2, frame_hop=160, prefetch=0, shuffle=True, seed=seed,
        drop_last=drop_last)
    orders = []
    for _ in range(3):
        np.testing.assert_array_equal(ours.peek_batch()['audio'],
                                      ref.peek_batch()['audio'])
        got, want = list(ours), list(ref)
        assert [b['paths'] for b in got] == [b['paths'] for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a['audio'], b['audio'])
            np.testing.assert_array_equal(a['batch_mask'], b['batch_mask'])
        assert all(b['batch_mask'].min() == 1 for b in got) or not drop_last
        orders.append([p for b in got for p in b['paths']])
    assert ours.epoch == ref.epoch == 3
    assert orders[0] != orders[1]  # each epoch its own order


def test_prefetch_thread_yields_the_same_batches(corpus):
    jsonl, _, _ = corpus
    ds = ManifestDataset(str(jsonl), SR, 'english_lowercase')
    sync = list(BucketBatchLoader(ds, 2, 160, prefetch=0))
    threaded = list(BucketBatchLoader(ds, 2, 160, prefetch=2))
    for a, b in zip(sync, threaded):
        np.testing.assert_array_equal(a['audio'], b['audio'])


def test_sample_rate_mismatch_raises(corpus):
    jsonl, _, _ = corpus
    with pytest.raises(ValueError, match='sample rate'):
        ManifestDataset(str(jsonl), 8000, 'english_lowercase')


def test_greedy_decoder_matches_jax():
    labels = resolve_labels('english_lowercase')
    rng = np.random.default_rng(1)
    # runs of repeats and blanks, so the collapse rule is exercised
    ids = np.repeat(rng.integers(0, len(labels), size=(3, 40)), 2, axis=1)
    sizes = np.array([80, 57, 3])
    assert GreedyDecoder(labels).decode_ids(ids, sizes) == \
        JaxGreedyDecoder(labels).decode_ids(ids, sizes)
    assert GreedyDecoder(labels).decode_ids(ids) == \
        JaxGreedyDecoder(labels).decode_ids(ids)


@pytest.mark.parametrize('ref,hyp', [('the cat sat', 'the cat sat'),
                                     ('the cat sat', 'a cat sat down'),
                                     ('abc', ''), ('', 'x y'),
                                     ('kitten', 'sitting')])
def test_wer_cer_and_distance_match_jax(ref, hyp):
    ours, theirs = GreedyDecoder('english'), JaxGreedyDecoder('english')
    assert ours.wer_ratio(ref, hyp) == theirs.wer_ratio(ref, hyp)
    assert ours.cer_ratio(ref, hyp) == theirs.cer_ratio(ref, hyp)
    assert levenshtein.distance(ref, hyp) == _py_distance(list(ref),
                                                          list(hyp))


def test_ratio_accumulator_matches_jax():
    ours, theirs = RatioAccumulator(), JaxRatioAccumulator()
    for num, den in ((1, 4), (0, 3), (2, 0)):
        for acc in (ours, theirs):
            acc.add('wer', num, den)
            acc.add('cer', 2 * num, den + 1)
    assert ours.ratios() == theirs.ratios()
