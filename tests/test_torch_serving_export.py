"""Serving artifacts and their inputs, the port vs the JAX package:
activation calibration, corpus CMVN, ``export_serving`` -> ``load_serving``
across the two packages in both directions, and the port's
``export_serving`` CLI over a tiny port run."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import N_MELS, SMALL_LAYERS, _build
from tests.test_train_e2e import _make_corpus
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu_torch import export_serving as export_cli
from wav2letter_pytorch_tpu_torch import serving
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

LABELS = list('_abcde ')
AUDIO_CONF = {'sample_rate': 16000, 'window_size': 0.02,
              'window_stride': 0.01, 'window': 'hamming'}
# Scales are percentiles of activations that differ by float32 rounding
# (~1e-7 relative): they agree far inside 1e-4.
SCALE_RTOL = 1e-4
# CMVN: float32 sums of features that agree to ~1e-6 (test_torch_frontend).
CMVN_ATOL = 1e-4


@pytest.fixture(scope='module')
def small():
    _, variables, _ = _build(SMALL_LAYERS)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def test_calibrate_activation_scales_matches_jax(small):
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((3, 20000)) * 0.1).astype(np.float32)
    lens = np.array([20000, 17000, 12345])
    audio[1, 17000:] = 0.0
    audio[2, 12345:] = 0.0
    folded = jserve.fold_batchnorm(small, len(SMALL_LAYERS))
    want = jserve.calibrate_activation_scales(
        SMALL_LAYERS, folded,
        JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0,
                    stft_method='conv'), audio, lens)
    got = serving.calibrate_activation_scales(
        SMALL_LAYERS, folded,
        SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
        audio, lens)
    assert len(got) == len(want) == 4
    assert all(isinstance(s, float) and s > 0 for s in got)
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL)


def test_compute_cmvn_matches_jax(tmp_path):
    manifest = _make_corpus(tmp_path)
    labels = ['_'] + list("abcdefghijklmnopqrstuvwxyz' ")
    want = jserve.compute_cmvn(
        manifest, lambda normalize: JaxFrontend(
            JaxAudio(), n_mels=N_MELS, dither=0.0, stft_method='conv',
            normalize=normalize), labels, AUDIO_CONF, limit=5)
    got = serving.compute_cmvn(
        manifest, lambda normalize: SpectrogramFrontend(
            AudioConfig(), n_mels=N_MELS, dither=0.0, normalize=normalize),
        labels, AUDIO_CONF, limit=5)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (N_MELS,)
        np.testing.assert_allclose(g, w, atol=CMVN_ATOL, rtol=0)
    assert (got[1] > 0).all()


def _export_kwargs(tmp_path, weights):
    rng = np.random.default_rng(9)
    lm = tmp_path / 'lm.arpa'
    lm.write_text('\\data\\\nngram 1=1\n\n\\1-grams:\n-1.0\tabba\n\n'
                  '\\end\\\n')
    return dict(labels=LABELS, audio_conf=AUDIO_CONF, weights=weights,
                norm_stats=(rng.standard_normal(N_MELS).astype(np.float32),
                            rng.uniform(0.5, 2, N_MELS).astype(np.float32)),
                act_scales=[0.01, 0.02, 0.03, 0.04], lm_path=str(lm),
                lm_beam_params={'k': 4, 'alpha': 0.5})


def _same_artifact(a, b):
    meta_a, folded_a, stats_a = a
    meta_b, folded_b, stats_b = b
    assert meta_a == meta_b
    assert len(folded_a) == len(folded_b)
    for x, y in zip(folded_a, folded_b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    for u, v in zip(stats_a, stats_b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize('weights', ['f32', 'int8'])
def test_artifacts_load_across_packages(small, tmp_path, weights):
    """The port's artifact of the same weights is the JAX package's, file
    for file: each package loads the other's and gets the same arrays and
    JSON fields."""
    kw = _export_kwargs(tmp_path, weights)
    jax_dir = jserve.export_serving(str(tmp_path / 'jax'), SMALL_LAYERS, 7,
                                    small, **kw)
    port_dir = serving.export_serving(str(tmp_path / 'port'), SMALL_LAYERS,
                                      7, state_dict_from_flax(small), **kw)
    with open(os.path.join(jax_dir, 'serving.json')) as f:
        jax_json = f.read()
    with open(os.path.join(port_dir, 'serving.json')) as f:
        assert f.read() == jax_json
    want = jserve.load_serving(jax_dir)
    assert want[0]['format'] == weights and want[0]['lm']['file'] == 'lm.arpa'
    for got in (serving.load_serving(jax_dir), jserve.load_serving(port_dir),
                serving.load_serving(port_dir)):
        _same_artifact(got, want)
    with open(os.path.join(port_dir, 'lm.arpa')) as f:
        assert f.read() == open(kw['lm_path']).read()


def test_jasper_artifact_loads_in_the_port(tmp_path):
    """``load_serving``'s Jasper branch (numpy only) reads an artifact the
    JAX package's ``export_serving_jasper`` wrote (JASPER_DENSE: separable
    and plain convs, dense residuals)."""
    from tests.test_streaming_jasper import JASPER_DENSE
    from tests.test_streaming_jasper import _build as build_jasper
    _, variables, _ = build_jasper(JASPER_DENSE)
    art = jserve.export_serving_jasper(
        str(tmp_path / 'jasper'), JASPER_DENSE, 7, variables, labels=LABELS,
        audio_conf=AUDIO_CONF, n_mels=N_MELS,
        norm_stats=(np.zeros(N_MELS, np.float32),
                    np.ones(N_MELS, np.float32)))
    want = jserve.load_serving(art)
    got = serving.load_serving(art)
    assert got[0] == want[0] and got[0]['family'] == 'jasper'
    g_leaves, g_tree = jax.tree_util.tree_flatten(got[1:])
    w_leaves, w_tree = jax.tree_util.tree_flatten(want[1:])
    assert g_tree == w_tree and len(g_leaves) > 20
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """A tiny port run (2 epochs over 6 short utterances) and a 3-gram LM."""
    from wav2letter_pytorch_tpu_torch import train as port_train
    from wav2letter_pytorch_tpu_torch.decoding.ngram_train import train_arpa
    root = tmp_path_factory.mktemp('export_run')
    manifest = _make_corpus(root)
    run = root / 'run'
    assert port_train.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        'data.batch_size=2', 'data.num_length_buckets=1',
        'model.input_size=32', 'model.layers.0.output_size=24',
        'model.layers.0.kernel_size=7', 'trainer.max_epochs=2',
        f'trainer.default_root_dir={run}', '--device', 'cpu']) == 0
    lm = str(root / 'lm.arpa')
    with open(manifest) as f:
        train_arpa([json.loads(line)['text'] for line in f], lm, order=3)
    return str(run), manifest, lm


def test_export_cli_on_a_port_run(port_run, tmp_path):
    """int8 + CMVN + calibration + a bundled LM: the artifact holds the
    run's fold, quantized, the corpus CMVN, one scale a layer, and the LM;
    the JAX package loads it as its own."""
    from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                             load_run)
    run, manifest, lm = port_run
    out = str(tmp_path / 'art')
    assert export_cli.main([
        '--model-path', run, '--out', out, '--int8', '--cmvn-manifest',
        manifest, '--calibrate', '--calibrate-clips', '4', '--lm-path', lm,
        '--lm-beam-params', 'k=4,alpha=0.5', '--device', 'cpu']) == 0
    cfg, model, labels, step = load_run(run)
    assert step == 6
    meta, folded, stats = serving.load_serving(out)
    assert meta['format'] == 'int8' and meta['labels'] == labels
    assert meta['n_mels'] == 32 and meta['num_layers'] == 2
    assert meta['lm'] == {'file': 'lm.arpa',
                          'beam_params': {'k': 4, 'alpha': 0.5}}
    assert len(meta['act_scales']) == 2
    want = serving.quantize_folded(serving.fold_batchnorm(model))
    for g, w in zip(folded, want):
        for u, v in zip(g, w):
            np.testing.assert_array_equal(u, v)
    fe = lambda normalize: build_frontend(  # noqa: E731
        cfg['model'], dither=0.0, normalize=normalize)
    for g, w in zip(stats, serving.compute_cmvn(
            manifest, fe, labels, cfg['model']['audio_conf'])):
        np.testing.assert_array_equal(g, w)
    _same_artifact(jserve.load_serving(out), serving.load_serving(out))


def test_export_cli_refusals(port_run, tmp_path):
    run, _, _ = port_run
    with pytest.raises(SystemExit, match='--calibrate needs --int8'):
        export_cli.main(['--model-path', run, '--out', str(tmp_path / 'a'),
                         '--calibrate', '--device', 'cpu'])
    jasper = tmp_path / 'jasper_run'
    jasper.mkdir()
    cfg = load_config(['data.train_manifest=-', 'data.val_manifest=-',
                       'model=quartznet'])
    (jasper / 'config.json').write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match='stored f32'):
        export_cli.main(['--model-path', str(jasper), '--out',
                         str(tmp_path / 'b'), '--int8', '--device', 'cpu'])
    assert not (tmp_path / 'b').exists()
