"""The port's whole evaluation slice vs the JAX ``Trainer._eval_step``.

Same WAV manifest, same weights (a JAX init carried across with
``weights.state_dict_from_flax``), the port on ``device='cpu'``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2letter_pytorch_tpu import optim
from wav2letter_pytorch_tpu.config import load_config
from wav2letter_pytorch_tpu.data.dataset import \
    BucketBatchLoader as JaxLoader
from wav2letter_pytorch_tpu.data.dataset import \
    ManifestDataset as JaxDataset
from wav2letter_pytorch_tpu.training import (Trainer, TrainState,
                                             build_decoder, build_frontend,
                                             build_labels, build_model)
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import resolve_device
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

LAYERS = [
    dict(output_size=32, kernel_size=11, stride=2, dilation=1, dropout=0.2),
    dict(output_size=32, kernel_size=11, stride=1, dilation=1, dropout=0.2),
    dict(output_size=48, kernel_size=13, stride=1, dilation=2, dropout=0.2),
]
# Loss: features, convs and CTC are float32 on both sides in a different
# summation order; the batch-mean loss agrees to ~1e-6 relative.
LOSS_RTOL = 1e-4
# Log-prob agreement (see test_torch_model); argmax ids must agree wherever
# the top-2 margin exceeds 10x this.
LOGP_TOL = 1e-4
WORDS = ['hello', 'world', 'the', 'quick', 'brown', 'fox', "it's", 'zz']


@pytest.fixture
def manifest(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        # one length bucket (edge 9120 samples): one compiled JAX program
        n = int(rng.integers(7841, 9121))
        t = np.arange(n) / 16000
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 800) * t)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        path = tmp_path / f'utt{i}.wav'
        write_wav(str(path), audio, 16000)
        text = ' '.join(rng.choice(WORDS, size=int(rng.integers(1, 4))))
        rows.append({'audio_filepath': str(path), 'text': text})
    path = tmp_path / 'manifest.jsonl'
    path.write_text('\n'.join(json.dumps(r) for r in rows) + '\n')
    return str(path)


def _jax_trainer(tmp_path, manifest):
    layers = ', '.join(
        '{' + ', '.join(f'{k}: {v}' for k, v in l.items()) + '}'
        for l in LAYERS)
    cfg = load_config([f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       'model.input_size=64', 'model.mid_layers=3',
                       f'model.layers=[{layers}]', 'model.stft_method=conv',
                       'trainer.mesh.data=1',
                       f'trainer.default_root_dir={tmp_path / "run"}'])
    labels = build_labels(cfg.model)
    trainer = Trainer(cfg, build_model(cfg.model, len(labels)),
                      build_frontend(cfg.model, dither=0.0),
                      optim.sgd(optim.constant_lr(1e-3)),
                      optim.constant_lr(1e-3),
                      build_decoder(cfg.model, labels),
                      run_dir=str(tmp_path / 'run'))
    return trainer, labels


def test_eval_slice_matches_jax_trainer(tmp_path, manifest):
    trainer, labels = _jax_trainer(tmp_path, manifest)
    jax_loader = JaxLoader(JaxDataset(manifest, {'sample_rate': 16000},
                                      labels),
                           2, num_buckets=4, max_duration=16.7,
                           shuffle=False, prefetch=0, frame_hop=160)
    # Initialise as Trainer.init_state does, from feature-shaped zeros (no
    # eager frontend call), then give BatchNorm non-trivial statistics so
    # their mapping is exercised.
    init = jax.jit(lambda k, x, l: trainer.model.init(k, x, l, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 57, 64)), jnp.array([57]))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), jax.device_get(init['batch_stats']))
    # A sharper head (x30) and a random head bias make the random model's
    # argmax decisive (frames whose activations all clamp to 0 would
    # otherwise tie exactly), so transcripts can be compared, not just
    # confident frames.
    params = jax.tree_util.tree_map(np.array, jax.device_get(init['params']))
    head = params['conv1d_3']['Conv_0']
    head['kernel'] *= 30.0
    head['bias'] = rng.normal(0.0, 1.0, head['bias'].shape).astype(np.float32)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=None,
                       rng=jax.random.PRNGKey(0))
    variables = {'params': params, 'batch_stats': stats}

    model = Wav2Letter(len(labels), input_size=64, layers=LAYERS,
                       mid_layers=3)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.eval()
    frontend = SpectrogramFrontend(AudioConfig(), n_mels=64, dither=0.0)
    loader = port_eval.make_loader(manifest, 2, frontend, prefetch=0)
    decoder = GreedyDecoder(labels)

    jax_step = jax.jit(trainer._eval_step)
    jax_losses = []
    n_compared = 0
    for ours, theirs in zip(loader, jax_loader):
        loss, ids, out_lens = jax_step(state, {
            k: jnp.asarray(v) for k, v in theirs.items()
            if isinstance(v, np.ndarray)})
        jax_losses.append(float(loss))
        batch = port_eval.to_device(ours, torch.device('cpu'))
        our_loss, our_ids, our_lens = port_eval.eval_step(model, frontend,
                                                          batch)
        np.testing.assert_allclose(float(our_loss), float(loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(our_lens.numpy(), np.asarray(out_lens))
        with torch.no_grad():
            logp, _ = model(*frontend(batch['audio'], batch['audio_lengths']))
        top2 = torch.topk(logp, 2, dim=-1).values
        confident = ((top2[..., 0] - top2[..., 1]) > 10 * LOGP_TOL).numpy()
        ids = np.asarray(ids)
        np.testing.assert_array_equal(our_ids.numpy()[confident],
                                      ids[confident])
        sizes = our_lens.numpy()
        ours_txt = decoder.decode_ids(our_ids.numpy(), sizes)
        jax_txt = decoder.decode_ids(ids, sizes)
        for j in range(len(sizes)):
            if confident[j, :sizes[j]].all():
                assert ours_txt[j] == jax_txt[j]
                n_compared += 1
    assert n_compared >= 4  # of 5 utterances (+1 masked padding row)

    result = port_eval.evaluate(model, frontend, loader, decoder, 'cpu')
    assert result['num_utterances'] == 5
    assert set(result) == {'loss', 'num_utterances', 'cer', 'wer'}
    np.testing.assert_allclose(result['loss'], np.mean(jax_losses),
                               rtol=LOSS_RTOL)


def test_cli_prints_test_py_json_and_loads_weights(tmp_path, manifest,
                                                   capsys):
    model, _, _ = port_eval.build('cpu', seed=3, mid_layers=1)
    weights = tmp_path / 'sd.pt'
    torch.save(model.state_dict(), weights)
    common = ['--test-manifest', manifest, '--device', 'cpu',
              '--mid-layers', '1', '--batch-size', '2']
    assert port_eval.main(common + ['--seed', '3']) == 0
    seeded = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_eval.main(common + ['--seed', '99', '--weights',
                                    str(weights)]) == 0
    loaded = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(seeded) == {'loss', 'num_utterances', 'cer', 'wer'}
    assert seeded['num_utterances'] == 5
    assert np.isfinite(seeded['loss'])
    assert loaded == seeded


def test_cuda_without_a_card_raises(monkeypatch, manifest):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_eval.main(['--test-manifest', manifest, '--mid-layers', '1'])
    assert resolve_device('cpu') == torch.device('cpu')
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _jax_default_loss(tmp_path, manifest, variables, batch_size):
    """The JAX eval loss as ``test.py`` computes it: the default config at
    one block, its loader built as ``test.py:239-243`` builds it, the mean
    of the per-batch losses. Returns (loss, number of batches)."""
    cfg = load_config([f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       'model.mid_layers=1', 'model.stft_method=conv',
                       'trainer.mesh.data=1',
                       f'trainer.default_root_dir={tmp_path / "run"}'])
    labels = build_labels(cfg.model)
    trainer = Trainer(cfg, build_model(cfg.model, len(labels)),
                      build_frontend(cfg.model, dither=0.0),
                      optim.sgd(optim.constant_lr(1e-3)),
                      optim.constant_lr(1e-3),
                      build_decoder(cfg.model, labels),
                      run_dir=str(tmp_path / 'run'))
    ac = cfg.data.audio_conf
    loader = JaxLoader(
        JaxDataset(manifest, ac, labels),
        batch_size or int(cfg.data.batch_size),
        num_buckets=int(cfg.data.get('num_length_buckets', 4)),
        max_duration=cfg.data.get('max_duration'), shuffle=False,
        prefetch=0, frame_hop=int(ac['sample_rate'] * ac['window_stride']))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables['params'],
                       batch_stats=variables['batch_stats'], opt_state=None,
                       rng=jax.random.PRNGKey(0))
    step = jax.jit(trainer._eval_step)
    losses = [float(step(state, {k: jnp.asarray(v) for k, v in b.items()
                                 if isinstance(v, np.ndarray)})[0])
              for b in loader]
    return float(np.mean(losses)), len(losses)


@pytest.mark.parametrize('overrides, batch_size, n_batches',
                         [([], 4, 2), (['data.batch_size=2'], 2, 3)])
def test_cli_batches_from_the_config_as_test_py(tmp_path, manifest, capsys,
                                                overrides, batch_size,
                                                n_batches):
    """Without --batch-size the CLI batches by the config's data block
    (batch 4 by default, or a data.batch_size override), its buckets and
    max_duration, and prints the loss test.py prints on the same weights;
    the 5 utterances give 2 batches at 4 and 3 at 2, and the two losses
    differ by far more than the tolerance."""
    cfg = load_config([f'data.train_manifest={manifest}',
                       f'data.val_manifest={manifest}',
                       'model.mid_layers=1', 'model.stft_method=conv'])
    labels = build_labels(cfg.model)
    model = build_model(cfg.model, len(labels))
    init = jax.jit(lambda k, x, l: model.init(k, x, l, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 57, 64)), jnp.array([57]))
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        np.array, {'params': jax.device_get(init['params']),
                   'batch_stats': jax.device_get(init['batch_stats'])})
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables['batch_stats'])
    weights = tmp_path / 'sd.pt'
    torch.save(state_dict_from_flax(variables), weights)

    want, n_jax = _jax_default_loss(tmp_path, manifest, variables,
                                       batch_size)
    other, _ = _jax_default_loss(tmp_path, manifest, variables,
                                    6 - batch_size)
    assert n_jax == n_batches
    assert abs(want - other) > 100 * LOSS_RTOL * abs(want)

    assert port_eval.main(['--test-manifest', manifest, '--device', 'cpu',
                           '--mid-layers', '1', '--weights', str(weights),
                           *overrides]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got['num_utterances'] == 5
    np.testing.assert_allclose(got['loss'], want, rtol=LOSS_RTOL)
