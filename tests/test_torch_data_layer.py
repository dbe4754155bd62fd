"""The port's data layer against the JAX package's, on the CPU.

The same seeded numpy audio, written as FLAC by the JAX package's encoder,
goes through the JAX ``ManifestDataset`` / ``BucketBatchLoader`` and the
port's: int16 batches, the audio cache (no file read twice) and loader
resampling. The port's frontend on int16 and under MFCC against the JAX
frontend; ``config.parse_value`` against ``yaml.safe_load``; the Hebrew
tools, ``prepare_librispeech`` (on a tarball made here) and
``make_offline_corpus`` against the JAX modules and script; a two-step
``full_depth_run`` at toy width.
"""

import csv
import json
import os
import sys
import tarfile

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from wav2letter_pytorch_tpu.data import flac as jflac
from wav2letter_pytorch_tpu.data import language_specific_tools as jlang
from wav2letter_pytorch_tpu.data import prepare_librispeech as jprep
from wav2letter_pytorch_tpu.data.dataset import \
    BucketBatchLoader as JaxLoader
from wav2letter_pytorch_tpu.data.dataset import ManifestDataset as JaxDataset
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu_torch import full_depth_run
from wav2letter_pytorch_tpu_torch import make_offline_corpus as corpus
from wav2letter_pytorch_tpu_torch.config import load_config, parse_value
from wav2letter_pytorch_tpu_torch.data import dataset as dataset_mod
from wav2letter_pytorch_tpu_torch.data import language_specific_tools as lang
from wav2letter_pytorch_tpu_torch.data import prepare_librispeech as prep
from wav2letter_pytorch_tpu_torch.data.dataset import (BucketBatchLoader,
                                                       ManifestDataset,
                                                       read_manifest)
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = 'english_lowercase'
TEXTS = ['abba', 'cab at', 'dad at bat', 'a cat sat', 'bad cab', 'tact']
# Raw features (log-mel, MFCC before normalisation): the JAX conv path and
# the port's plain DFT sum 512 float32 products in another order.
RAW_RTOL = 1e-5


def _write_corpus(root, rates, n=6, seed=0):
    """A CSV manifest (pandas' layout) of FLAC files at ``rates`` (cycled),
    16-bit, 0.3-0.5 s of tone and noise; written by the JAX encoder."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        sr = rates[i % len(rates)]
        t = np.arange(int((0.3 + 0.1 * (i % 3)) * sr)) / sr
        x = 0.3 * np.sin(2 * np.pi * (250 + 60 * i) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        path = str(root / f'utt{i}.flac')
        jflac.write_flac_file(path, x.astype(np.float32), sr)
        rows.append((path, TEXTS[i % len(TEXTS)]))
    manifest = str(root / f'm{"_".join(map(str, rates))}.csv')
    prep.write_csv_manifest(rows, manifest)
    return manifest


def _loaders(manifest, resample=False, **kw):
    conf = {'sample_rate': 16000, 'resample': resample}
    ours = BucketBatchLoader(
        ManifestDataset(manifest, 16000, LABELS, resample=resample, **kw), 2,
        160, num_buckets=2, prefetch=0)
    ref = JaxLoader(JaxDataset(manifest, conf, LABELS, **kw), 2,
                    num_buckets=2, frame_hop=160, prefetch=0)
    return ours, ref


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize('audio_dtype,cache', [('float32', False),
                                               ('int16', False),
                                               ('int16', True)])
def test_flac_loader_matches_jax(tmp_path, audio_dtype, cache):
    manifest = _write_corpus(tmp_path, [16000])
    ours, ref = _loaders(manifest, audio_dtype=audio_dtype,
                         cache_audio=cache)
    assert ours.bucket_edges == ref.bucket_edges
    got = list(ours)
    _assert_batches_equal(got, list(ref))
    assert got[0]['audio'].dtype == np.dtype(audio_dtype)
    if audio_dtype == 'int16':
        f32, _ = _loaders(manifest)
        for a, b in zip(got, list(f32)):
            np.testing.assert_array_equal(
                a['audio'].astype(np.float32) / 32768.0, b['audio'])


def test_cache_decodes_each_file_once(tmp_path, monkeypatch):
    manifest = _write_corpus(tmp_path, [16000])
    reads = []
    real = dataset_mod.read_audio

    def counting(path, *args):
        reads.append(path)
        return real(path, *args)
    monkeypatch.setattr(dataset_mod, 'read_audio', counting)
    ours, ref = _loaders(manifest, cache_audio=True, audio_dtype='int16')
    first, second = list(ours), list(ours)
    assert len(reads) == 6 and len(set(reads)) == 6
    _assert_batches_equal(second, first)
    _assert_batches_equal(first, list(ref))
    _assert_batches_equal(second, list(ref))
    reads.clear()
    plain, _ = _loaders(manifest)
    list(plain), list(plain)
    assert len(reads) == 12


@pytest.mark.parametrize('audio_dtype', ['float32', 'int16'])
def test_resampling_loader_matches_jax(tmp_path, audio_dtype):
    manifest = _write_corpus(tmp_path, [8000, 22050, 16000])
    with pytest.raises(ValueError, match='sample rate'):
        ManifestDataset(manifest, 16000, LABELS)
    ours, ref = _loaders(manifest, resample=True, audio_dtype=audio_dtype)
    ds = ours.dataset
    for i, row in enumerate(ds.rows):
        with open(row['audio_filepath'], 'rb') as f:
            info = jflac.read_flac_info(f.read())
        assert info.sample_rate == [8000, 22050, 16000][i % 3]
        up, down = {8000: (2, 1), 22050: (320, 441), 16000: (1, 1)}[
            info.sample_rate]
        assert ds.sample_meta(i)[0] == -(-info.total_samples * up // down)
        assert len(ds[i][0]) == ds.sample_meta(i)[0]
    _assert_batches_equal(list(ours), list(ref))


def _features_pair(feature_type='logmel', norm=True):
    kw = dict(n_mels=16, dither=0.0, feature_type=feature_type)
    if feature_type == 'mfcc':
        kw['n_mfcc'] = 12
    jfe = JaxFrontend(JaxAudio(), normalize=norm, **kw)
    fe = SpectrogramFrontend(AudioConfig(), normalize=norm, **kw)
    return jfe, fe


def _pcm_batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([8000, 6001, 2500], np.int32)
    pcm = np.clip(rng.normal(0, 3000, (3, 8000)), -32768, 32767) \
        .astype(np.int16)
    pcm[np.arange(8000)[None, :] >= lens[:, None]] = 0
    return pcm, lens


def test_int16_features_equal_f32_and_match_jax():
    pcm, lens = _pcm_batch()
    jfe, fe = _features_pair(norm=False)
    f32 = pcm.astype(np.float32) / 32768.0
    with torch.no_grad():
        a, la = fe(torch.from_numpy(pcm), torch.from_numpy(lens))
        b, lb = fe(torch.from_numpy(f32), torch.from_numpy(lens))
    assert torch.equal(a, b) and torch.equal(la, lb)
    ref, _ = jfe(jnp.asarray(pcm), jnp.asarray(lens))
    ref = np.asarray(ref)
    np.testing.assert_allclose(a.numpy(), ref,
                               atol=RAW_RTOL * np.abs(ref).max())
    # dither draws noise after the int16 -> f32 step, on both wires
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    with torch.no_grad():
        a = fe.prepare(torch.from_numpy(pcm), torch.from_numpy(lens), g[0])
        b = fe.prepare(torch.from_numpy(f32), torch.from_numpy(lens), g[1])
    assert torch.equal(a, b)


@pytest.mark.parametrize('norm', [False, True])
def test_mfcc_features_match_jax(norm):
    pcm, lens = _pcm_batch(1)
    audio = pcm.astype(np.float32) / 32768.0
    jfe, fe = _features_pair('mfcc', norm)
    np.testing.assert_array_equal(fe.dct.numpy(), jfe.dct)
    assert fe.feat_dim == 12
    with torch.no_grad():
        got, glens = fe(torch.from_numpy(audio), torch.from_numpy(lens))
    ref, rlens = jfe(jnp.asarray(audio), jnp.asarray(lens))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (3, 51, 12)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(rlens))
    # normalised: a per-coefficient std divides, as the port's frontend
    # tests allow (1e-3) for log-mel; raw: 1e-5 of the largest feature
    tol = 1e-3 if norm else RAW_RTOL * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)


def test_frontend_and_config_refuse_bad_values():
    with pytest.raises(ValueError, match='feature_type'):
        SpectrogramFrontend(AudioConfig(), feature_type='plp')
    base = ['data.train_manifest=x', 'data.val_manifest=y']
    for override, match in (('data.audio_dtype=float16', 'audio_dtype'),
                            ('model.feature_type=plp', 'feature_type'),
                            ('model.n_mfcc=0', 'n_mfcc')):
        with pytest.raises(ValueError, match=match):
            load_config(base + [override])
    cfg = load_config(base + ['data.cache_audio=true',
                              'data.audio_dtype=int16',
                              'model.audio_conf.resample=true',
                              'model.feature_type=mfcc', 'model.n_mfcc=64'])
    assert cfg['data']['audio_conf']['resample'] is True
    assert (cfg['data']['cache_audio'], cfg['data']['audio_dtype']) == (
        True, 'int16')
    assert (cfg['model']['feature_type'], cfg['model']['n_mfcc']) == (
        'mfcc', 64)


# Every override of the JAX recipe (scripts/full_depth_run.py) at its
# default arguments, then list and map values and scalars both parsers
# read alike.
JAX_RECIPE = [
    'data.train_manifest=/tmp/w2l_corpus/train_manifest.csv',
    'data.val_manifest=/tmp/w2l_corpus/val_manifest.csv',
    'data.batch_size=16', 'data.num_length_buckets=3',
    'data.cache_audio=true', 'data.audio_dtype=int16', 'model=wav2letter',
    'optimizer=novograd', 'model.optimizer.lr=0.002',
    'model.scheduler.gamma=0.985', 'model.mid_layers=20',
    'model.labels=english_lowercase',
    'data.augment={spec_augment: {freq_masks: 2, time_masks: 2, '
    'freq_width: 10, time_width: 20}}',
    'trainer.max_epochs=60', 'trainer.string_metrics_interval=50',
    'trainer.log_every_n_steps=50', 'trainer.steps_per_dispatch=4',
    'trainer.val_every_n_epochs=5', 'trainer.checkpoint.every_n_epochs=5',
    'trainer.default_root_dir=/tmp/w2l_full_run',
    'trainer.host_rss_budget_gb=26',
]
VALUES = [
    '[1, 2]', '[]', '{}', '[[1, 2], [3]]', '{a: [1, {b: null}], c: ~}',
    '[a, b c, -3, 2.5, true, false, null]', "{a: 'x, y', b: \"q: r\"}",
    "['it''s', \"tab\\tend\"]", '[1, 2, ]', '{a, b: 1}', '{a: }',
    '[http://host:8000/x, a:b]', '{k: v, n: {m: {o: [0.5, 1.0e+3]}}}',
    '[ spaced ,  out ]', '{spec_augment: {}}',
    '{spec_cutout: {rect_masks: 5}}',
    'model.layers', '0.985', '-7', '16', 'true', 'False', 'null', '~',
    'english_lowercase', '/a/b.csv', "'quoted'", '"double"',
]


@pytest.mark.parametrize('text', [o.partition('=')[2] for o in JAX_RECIPE]
                         + VALUES)
def test_parse_value_matches_yaml(text):
    assert parse_value(text) == yaml.safe_load(text)


def test_recipe_is_the_jax_recipe_less_the_tpu_knobs():
    args = full_depth_run.parse_args(['--corpus-root', '/tmp/w2l_corpus',
                                      '--run-dir', '/tmp/w2l_full_run'])
    manifests = {s: f'/tmp/w2l_corpus/{s}_manifest.csv'
                 for s in ('train', 'val', 'test')}
    assert full_depth_run.recipe_overrides(args, manifests) == [
        o for o in JAX_RECIPE if not o.startswith(
            ('trainer.steps_per_dispatch', 'trainer.host_rss_budget_gb'))]
    cfg = load_config(full_depth_run.recipe_overrides(args, manifests))
    assert cfg['data']['augment'] == {'spec_augment': {
        'freq_masks': 2, 'time_masks': 2, 'freq_width': 10,
        'time_width': 20}}
    with pytest.raises(ValueError, match='Malformed'):
        parse_value('{a: [1, 2}')


@pytest.mark.parametrize('text', [
    'שלום מה', ['כלב צפ', 'עט מ', 'ם'], 'אבנ פ כ', '', 'נ נ נ',
    ['שלום', ['nested']][:1]])
def test_hebrew_tools_match_jax(text):
    for fn in ('hebrew_normal_to_final', 'hebrew_final_to_normal'):
        once = getattr(lang, fn)(text)
        assert once == getattr(jlang, fn)(text)
        assert getattr(lang, fn)(once) == getattr(jlang, fn)(once)


def _librispeech_tarball(download_dir, subset='dev-clean'):
    """A LibriSpeech-shaped ``<subset>.tar.gz``: two speakers, FLAC files
    and their ``.trans.txt``."""
    src = download_dir / 'src'
    for spk, chap, texts in (('84', '121123', ['GO DO', 'YOU, SIR']),
                             ('174', '50561', ['A "QUOTED" LINE'])):
        d = src / 'LibriSpeech' / subset / spk / chap
        d.mkdir(parents=True)
        lines = []
        for i, t in enumerate(texts):
            utt = f'{spk}-{chap}-{i:04d}'
            jflac.write_flac_file(str(d / f'{utt}.flac'),
                                  np.zeros(160, np.float32), 16000)
            lines.append(f'{utt} {t}')
        (d / f'{spk}-{chap}.trans.txt').write_text('\n'.join(lines) + '\n')
    tar = download_dir / f'{subset}.tar.gz'
    with tarfile.open(tar, 'w:gz') as f:
        f.add(src / 'LibriSpeech', arcname='LibriSpeech')
    return tar


@pytest.mark.parametrize('absolute', [False, True])
def test_prepare_librispeech_matches_jax(tmp_path, capsys, absolute):
    _librispeech_tarball(tmp_path)
    out = {}
    for name, mod in (('port', prep), ('jax', jprep)):
        manifest = tmp_path / f'{name}.csv'
        argv = ['--download_dir', str(tmp_path), '--extracted_dir',
                str(tmp_path / f'x_{name}'), '--manifest_path',
                str(manifest)] + (['--absolute_paths'] if absolute else [])
        assert mod.main(argv) == 0
        out[name] = manifest.read_text().replace(f'x_{name}', 'X')
        assert 'skipping download' in capsys.readouterr().out
    assert out['port'] == out['jax']
    rows = read_manifest(str(tmp_path / 'port.csv'))
    assert [r['text'] for r in rows] == ['A "QUOTED" LINE', 'GO DO',
                                         'YOU, SIR']
    assert all(os.path.exists(r['audio_filepath']) for r in rows)
    assert prep.read_transcriptions('dev-clean', str(tmp_path / 'x_port')) \
        == [(p.replace('x_jax', 'x_port'), t) for p, t in
            jprep.read_transcriptions('dev-clean', str(tmp_path / 'x_jax'))]


@pytest.fixture(scope='module')
def jax_corpus_script():
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import make_offline_corpus as script
    finally:
        sys.path.pop(0)
    return script


@pytest.mark.parametrize('extra', [[], ['--lang', 'hebrew', '--wav',
                                        '--sample-rate', '8000']])
def test_make_offline_corpus_matches_jax_script(tmp_path, capsys,
                                                jax_corpus_script, extra):
    argv = ['--n-train', '2', '--n-val', '1', '--n-test', '1', '--seed',
            '5', *extra]
    assert corpus.main(['--root', str(tmp_path / 'p'), *argv]) == 0
    assert jax_corpus_script.main(['--root', str(tmp_path / 'j'),
                                   *argv]) == 0
    capsys.readouterr()
    ext = 'wav' if '--wav' in extra else 'flac'
    for split, n in (('train', 2), ('val', 1), ('test', 1)):
        for i in range(n):
            rel = os.path.join(split, f'utt{i}.{ext}')
            assert (tmp_path / 'p' / rel).read_bytes() == \
                (tmp_path / 'j' / rel).read_bytes(), rel
        ours = (tmp_path / 'p' / f'{split}_manifest.csv').read_text()
        theirs = (tmp_path / 'j' / f'{split}_manifest.csv').read_text()
        assert ours.replace(str(tmp_path / 'p'), 'R') == \
            theirs.replace(str(tmp_path / 'j'), 'R')


def test_full_depth_run_two_steps_at_toy_width(tmp_path, capsys):
    corpus.main(['--root', str(tmp_path / 'c'), '--n-train', '4',
                 '--n-val', '2', '--n-test', '2'])
    run = tmp_path / 'run'
    rc = full_depth_run.main([
        '--corpus-root', str(tmp_path / 'c'), '--run-dir', str(run),
        '--epochs', '1', '--batch-size', '2', '--mid-layers', '1', '--cpu',
        '--override', 'model.layers=[{output_size: 8, kernel_size: 11, '
        'stride: 2, dilation: 1, dropout: 0.0}]',
        '--override', 'trainer.log_every_n_steps=1',
        '--override', 'trainer.max_steps=2',
        '--override', 'trainer.checkpoint.every_n_epochs=1'])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result == json.loads((run / 'full_depth_run.json').read_text())
    cfg = json.loads((run / 'config.json').read_text())
    assert cfg['data']['cache_audio'] is True
    assert cfg['data']['audio_dtype'] == 'int16'
    assert cfg['data']['augment']['spec_augment']['time_width'] == 20
    with open(run / 'metrics.csv') as f:
        steps = {int(r['step']) for r in csv.DictReader(f)
                 if r['metric'] == 'train_loss'}
    assert steps == {1, 2}
    for key in ('val_greedy', 'test_greedy', 'test_beam', 'test_beam_lm',
                'test_streaming', 'test_streaming_cmvn',
                'test_streaming_la96', 'test_streaming_la96_cmvn',
                'test_artifact_offline'):
        assert np.isfinite(result[key]['wer']), key
    assert result['test_streaming_cmvn']['normalization'] == 'cmvn'
    assert result['test_artifact_offline']['weights'] == 'int8'


def test_mfcc_eval_forward_matches_jax():
    """A JAX MFCC model (12 coefficients of 16 mel bands, so its
    ``input_size`` is 12) carried across by ``state_dict_from_flax``: the
    port's frontend + model give JAX's log-probs."""
    import jax

    from wav2letter_pytorch_tpu.models import Wav2Letter as JaxW2L
    from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
    from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax
    layers = [dict(output_size=16, kernel_size=7, stride=2, dilation=1,
                   dropout=0.0),
              dict(output_size=24, kernel_size=5, stride=1, dilation=2,
                   dropout=0.0)]
    jfe, fe = _features_pair('mfcc')
    pcm, lens = _pcm_batch(2)
    audio = pcm.astype(np.float32) / 32768.0
    jfeats, jflens = jfe(jnp.asarray(audio), jnp.asarray(lens))
    jmodel = JaxW2L(layers=layers, num_labels=29, mid_layers=2,
                    precision='highest')
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jfeats, jflens, train=False)))
    want, want_lens = jmodel.apply(variables, jfeats, jflens, train=False)
    model = Wav2Letter(29, input_size=12, layers=layers, mid_layers=2)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got, got_lens = model.eval()(*fe(torch.from_numpy(pcm),
                                         torch.from_numpy(lens)))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
