"""The port's whole evaluation slice vs the JAX ``Trainer._eval_step``.

Same WAV manifest, same weights (a JAX init carried across with
``weights.state_dict_from_flax``), the port on ``device='cpu'``.
"""

import json
import os

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


# --------------------------------------------------- run directories, beam

def _train_port_run(root, manifest):
    from wav2letter_pytorch_tpu_torch import train as port_train
    run = root / 'run'
    assert port_train.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        'data.batch_size=2', 'data.num_length_buckets=1',
        'model.input_size=32', 'model.layers.0.output_size=24',
        'model.layers.0.kernel_size=7', 'trainer.max_epochs=2',
        'trainer.log_every_n_steps=1', f'trainer.default_root_dir={run}',
        '--device', 'cpu']) == 0
    return str(run)


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """A port run over 6 short utterances: 2 epochs of 3 steps, a
    checkpoint after each (steps 3 and 6), plus a 3-gram LM trained on
    the transcripts."""
    from tests.test_train_e2e import _make_corpus
    from wav2letter_pytorch_tpu_torch.decoding.ngram_train import train_arpa
    root = tmp_path_factory.mktemp('port_run')
    manifest = _make_corpus(root)
    run = _train_port_run(root, manifest)
    lm = str(root / 'lm.arpa')
    with open(manifest) as f:
        train_arpa([json.loads(line)['text'] for line in f], lm, order=3)
    return run, manifest, lm


def _run_cli(argv, capsys):
    assert port_eval.main(argv) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1], captured.err


def _hand_loss(state_dict, cfg, manifest):
    model = port_eval.build_model(cfg['model'], 29)
    model.load_state_dict(state_dict)
    model.eval()
    frontend = port_eval.build_frontend(cfg['model'], dither=0.0)
    loader = port_eval.make_loader(manifest, 2, frontend, num_buckets=1,
                                   prefetch=0)
    return port_eval.evaluate(model, frontend, loader,
                              GreedyDecoder('english_lowercase'),
                              'cpu')['loss']


def test_model_path_restores_and_averages_checkpoints(port_run, capsys):
    from wav2letter_pytorch_tpu_torch.training.build import (load_run,
                                                             run_config)
    run, manifest, _ = port_run
    ckpts = [torch.load(f'{run}/checkpoints/ckpt_{s}.pt', weights_only=True)
             for s in (3, 6)]
    averaged = {k: ((ckpts[0]['model'][k].double()
                     + ckpts[1]['model'][k].double()) / 2).to(v.dtype)
                if torch.is_floating_point(v) else v
                for k, v in ckpts[1]['model'].items()}
    _, model, _, step = load_run(run, average_last=2)
    assert step == 6
    for k, v in model.state_dict().items():
        assert torch.equal(v, averaged[k]), k
    cfg = run_config(run)

    common = ['--model-path', run, '--test-manifest', manifest,
              '--device', 'cpu']
    latest, _, err = _run_cli(common, capsys)
    assert 'Loaded checkpoint at step 6' in err
    avg, _, err = _run_cli(common + ['--average-last', '2'], capsys)
    assert 'Averaged last 2 checkpoints (through step 6)' in err
    assert latest['num_utterances'] == avg['num_utterances'] == 6
    np.testing.assert_allclose(latest['loss'], _hand_loss(
        ckpts[1]['model'], cfg, manifest), rtol=1e-6)
    np.testing.assert_allclose(avg['loss'], _hand_loss(averaged, cfg,
                                                        manifest), rtol=1e-6)
    assert abs(avg['loss'] - latest['loss']) > 1e-3 * abs(latest['loss'])


def test_model_path_without_checkpoint_and_bad_flags(tmp_path, port_run,
                                                     capsys):
    run, manifest, _ = port_run
    empty = tmp_path / 'empty_run'
    empty.mkdir()
    (empty / 'config.json').write_text(
        open(f'{run}/config.json').read())
    result, _, err = _run_cli(['--model-path', str(empty), '--test-manifest',
                               manifest, '--device', 'cpu'], capsys)
    assert 'WARNING: no checkpoint found' in err
    assert result['num_utterances'] == 6
    for argv in (['--average-last', '2'],
                 ['--model-path', run, '--weights', 'w.pt']):
        with pytest.raises(SystemExit):
            port_eval.main(['--test-manifest', manifest] + argv)


@pytest.mark.parametrize('beam', [
    ['--beam-search-params', 'k=4,alpha=0.5,beta=1'],
    ['--hotwords', 'cab,bat', '--hotword-weight', '3',
     '--beam-search-params', 'k=4']])
def test_device_backend_gives_the_host_strings(tmp_path, port_run, capsys,
                                               beam):
    """Beam + LM (and hotwords) through the batched device search on the
    CPU and through the host C++ search: the same records and lines."""
    run, manifest, lm = port_run
    outs = {}
    for backend in ('host', 'device'):
        dump = tmp_path / f'{backend}.jsonl'
        result, lines, _ = _run_cli(
            ['--model-path', run, '--test-manifest', manifest, '--device',
             'cpu', '--lm-path', lm, '--beam-backend', backend,
             '--word-timings', '--print-all', '--dump-jsonl', str(dump),
             *beam], capsys)
        outs[backend] = (result, lines, dump.read_text())
    assert outs['host'] == outs['device']
    result, lines, dump = outs['host']
    hyps = [json.loads(line)['hyp'] for line in dump.splitlines()]
    assert len(hyps) == 6 and sum(' ' in h for h in hyps) >= 2
    assert sum(line.startswith('timings  :') for line in lines) == 6


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A tiny JAX run (test_eval_cli's), its weights exported with
    scripts/export_torch_checkpoint.py, and a 3-gram LM."""
    import sys

    import train as jax_train
    from tests.test_train_e2e import _make_corpus
    from wav2letter_pytorch_tpu.decoding.ngram_train import train_arpa
    root = tmp_path_factory.mktemp('jax_run')
    manifest = _make_corpus(root)
    run = root / 'run'
    assert jax_train.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        'data.batch_size=2', 'data.num_length_buckets=1',
        'model.input_size=32',
        'model.layers=[{output_size: 24, kernel_size: 7, stride: 2, '
        'dilation: 1, dropout: 0.1}]',
        'trainer.max_epochs=1', 'trainer.max_steps=3',
        'trainer.string_metrics_interval=0', 'trainer.mesh.data=2',
        f'trainer.default_root_dir={run}']) == 0
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import export_torch_checkpoint
    finally:
        sys.path.remove(os.path.join(REPO, 'scripts'))
    export = str(root / 'export.ckpt')
    assert export_torch_checkpoint.main(['--model-path', str(run), '--out',
                                         export]) == 0
    lm = str(root / 'lm.arpa')
    with open(manifest) as f:
        train_arpa([json.loads(line)['text'] for line in f], lm, order=3)
    return str(run), manifest, export, lm


# The JAX run's config.yaml, as the port's overrides.
JAX_RUN_OVERRIDES = ['model.input_size=32', 'model.mid_layers=1',
                     'model.layers.0.output_size=24',
                     'model.layers.0.kernel_size=7',
                     'model.layers.0.dropout=0.1', 'data.batch_size=2',
                     'data.num_length_buckets=1']


@pytest.mark.parametrize('decode', [
    [], ['--beam-search-params', 'k=4,alpha=0.5,beta=1', '--lm-path']])
def test_exported_jax_run_prints_what_test_py_prints(tmp_path, jax_run,
                                                     capsys, decode):
    """evaluate --weights <export> vs test.py --model-path <run>: the same
    (reference, decoded) pairs, word timings and --dump-jsonl records, WER
    and CER equal, the loss within LOSS_RTOL."""
    import test as test_cli
    run, manifest, export, lm = jax_run
    decode = decode + [lm] if decode else decode
    common = ['--test-manifest', manifest, '--print-all', '--word-timings',
              *decode]
    assert test_cli.main(['--model-path', run, *common, '--dump-jsonl',
                          str(tmp_path / 'jax.jsonl')]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    want = json.loads(out[-1])
    want_lines = [line for line in out[:-1] if line.startswith(
        ('reference: ', 'decoded  : ', 'timings  : '))]
    got, got_lines, _ = _run_cli(
        ['--weights', export, '--device', 'cpu', *common, '--dump-jsonl',
         str(tmp_path / 'port.jsonl'), *JAX_RUN_OVERRIDES], capsys)
    assert len(want_lines) == 18
    assert got_lines == want_lines
    assert (tmp_path / 'port.jsonl').read_text() == \
        (tmp_path / 'jax.jsonl').read_text()
    assert got['num_utterances'] == want['num_utterances'] == 6
    assert (got['wer'], got['cer']) == (want['wer'], want['cer'])
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)


# ------------------------------------------------------ serving artifacts

def _jax_export(run, out, *extra):
    import sys
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import export_serving as jax_export
    finally:
        sys.path.remove(os.path.join(REPO, 'scripts'))
    assert jax_export.main(['--model-path', run, '--out', out, *extra]) == 0
    return out


@pytest.mark.parametrize('export, flags', [
    ([], []),
    (['--cmvn-manifest', '{manifest}'], ['--offline-norm', 'cmvn']),
    (['--int8', '--cmvn-manifest', '{manifest}', '--calibrate'],
     ['--int8-full']),
    (['--lm-beam-params', 'k=4,alpha=0.5,beta=1', '--lm-path', '{lm}'],
     [])],
    ids=['f32', 'cmvn', 'int8_full', 'bundled_lm'])
def test_artifact_offline_eval_prints_what_test_py_prints(
        tmp_path, jax_run, capsys, export, flags):
    """An artifact written by the JAX package's scripts/export_serving.py,
    evaluated by test.py --artifact --offline and by the port's evaluate
    --artifact --offline on the CPU: the same (reference, decoded) pairs,
    --dump-jsonl records and result line (but mesh_devices: JAX's test
    mesh has 8 host devices, the port runs on one)."""
    import test as test_cli
    run, manifest, _, lm = jax_run
    export = [a.format(manifest=manifest, lm=lm) for a in export]
    art = _jax_export(run, str(tmp_path / 'art'), *export)
    common = ['--artifact', art, '--offline', '--test-manifest', manifest,
              '--print-all', *flags]
    assert test_cli.main([*common, '--dump-jsonl',
                          str(tmp_path / 'jax.jsonl')]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    want = json.loads(out[-1])
    want_lines = [line for line in out[:-1]
                  if line.startswith(('reference: ', 'decoded  : '))]
    got, got_lines, _ = _run_cli([*common, '--device', 'cpu', '--dump-jsonl',
                                  str(tmp_path / 'port.jsonl')], capsys)
    assert len(want_lines) == 12 and got_lines == want_lines
    assert (tmp_path / 'port.jsonl').read_text() == \
        (tmp_path / 'jax.jsonl').read_text()
    assert want.pop('mesh_devices') == 8 and got.pop('mesh_devices') == 1
    assert got == want
    assert got['decode'] == ('beam_lm' if '--lm-path' in export
                             else 'greedy')


def test_artifact_of_a_port_run_scores_as_its_run(port_run, tmp_path,
                                                  capsys):
    """The port's export of a run, evaluated --artifact --offline, gives
    the WER and CER of evaluate --model-path on the same batches; the
    bundled LM beam-decodes unless --no-lm."""
    from wav2letter_pytorch_tpu_torch import export_serving as export_cli
    run, manifest, lm = port_run
    art = str(tmp_path / 'art')
    assert export_cli.main(['--model-path', run, '--out', art, '--lm-path',
                            lm, '--device', 'cpu']) == 0
    want, _, _ = _run_cli(['--model-path', run, '--test-manifest', manifest,
                           '--device', 'cpu', '--batch-size', '8',
                           'data.num_length_buckets=4'], capsys)
    common = ['--artifact', art, '--offline', '--test-manifest', manifest,
              '--device', 'cpu']
    greedy, _, _ = _run_cli(common + ['--no-lm'], capsys)
    assert greedy['decode'] == 'greedy' and greedy['loss'] is None
    assert (greedy['wer'], greedy['cer']) == (want['wer'], want['cer'])
    beam, _, _ = _run_cli(common, capsys)
    assert beam['decode'] == 'beam_lm' and beam['weights'] == 'f32'
    assert beam['num_utterances'] == want['num_utterances'] == 6


@pytest.mark.parametrize('argv, match', [
    (['--artifact', '{jasper_art}', '--offline'], 'supports wav2letter'),
    (['--offline'], 'artifact-eval mode'),
    (['--int8-full'], 'applies to --artifact --offline'),
    (['--artifact', '{art}', '--offline', '--word-timings'],
     '--word-timings is not supported with --artifact'),
    (['--artifact', '{art}', '--lm-path', 'lm.arpa'],
     '--lm-path is not supported with --artifact'),
    (['--artifact', '{art}', '--offline', '--model-path', 'run'],
     '--model-path is not supported with --artifact'),
    (['--artifact', '{art}', '--offline', '--offline-norm', 'cmvn'],
     'no CMVN stats'),
    (['--artifact', '{art}', '--offline', '--beam-backend', 'device'],
     'beam-backend device')])
def test_artifact_flags_refused(port_run, tmp_path, argv, match):
    """Flags an artifact evaluation refuses, as test.py's; a Jasper
    artifact (here a Wav2Letter artifact relabelled as one) streams but
    is refused --offline, as test.py refuses it."""
    from wav2letter_pytorch_tpu_torch import export_serving as export_cli
    run, manifest, _ = port_run
    art = str(tmp_path / 'art')
    assert export_cli.main(['--model-path', run, '--out', art, '--device',
                            'cpu']) == 0
    jasper_art = tmp_path / 'jasper_art'
    jasper_art.mkdir()
    meta = json.loads((tmp_path / 'art' / 'serving.json').read_text())
    (jasper_art / 'serving.json').write_text(json.dumps(
        {**meta, 'family': 'jasper', 'blocks_meta': []}))
    arrays = dict(np.load(tmp_path / 'art' / 'serving.npz'))
    n = meta['num_layers'] - 1
    np.savez(jasper_art / 'serving.npz', head_w=arrays[f'w{n}'],
             head_b=arrays[f'b{n}'])
    with pytest.raises(SystemExit, match=match):
        port_eval.main(['--test-manifest', manifest, '--device', 'cpu',
                        *[a.format(art=art, jasper_art=str(jasper_art))
                          for a in argv]])


# ------------------------------------------------------------- streaming

def _print_lines(lines):
    return [line for line in lines if line.startswith(
        ('reference: ', 'decoded  : ', 'timings  : '))]


@pytest.mark.parametrize('mode', [
    ['--streaming-chunk-frames', '16', '--word-timings'],
    ['--streaming-chunk-frames', '16', '--int8', '--streaming-norm', 'cmvn',
     '--streaming-cmvn-manifest', '{manifest}', '--word-timings',
     '--beam-search-params', 'k=4,alpha=0.5,beta=1', '--lm-path', '{lm}'],
    ['--streaming-chunk-frames', '16', '--lookahead-frames', '8'],
    []],
    ids=['greedy', 'int8_cmvn_beam_lm', 'lookahead', 'below_prime'])
def test_streaming_prints_what_test_py_prints(tmp_path, jax_run, capsys,
                                              mode):
    """test.py --streaming on the JAX run and the port's evaluate
    --streaming on its exported weights, on the CPU: the same
    (reference, decoded) pairs, word timings, dump records and JSON line
    (keys and values, WER and CER included). Chunk 16 streams every
    utterance (beam + LM and word timings on int8 weights with corpus
    CMVN); the default chunk of 64 puts every one below the prime window,
    through the eval-forward fallback; --lookahead-frames 8 runs the
    bounded-lookahead streamer."""
    import test as test_cli
    run, manifest, export, lm = jax_run
    mode = [a.format(manifest=manifest, lm=lm) for a in mode]
    common = ['--test-manifest', manifest, '--streaming', '--print-all',
              *mode]
    assert test_cli.main(['--model-path', run, *common, '--dump-jsonl',
                          str(tmp_path / 'jax.jsonl')]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    want = json.loads(out[-1])
    got, got_lines, _ = _run_cli(
        ['--weights', export, '--device', 'cpu', *common, '--dump-jsonl',
         str(tmp_path / 'port.jsonl'), *JAX_RUN_OVERRIDES], capsys)
    assert _print_lines(got_lines) == _print_lines(out[:-1])
    assert len(_print_lines(got_lines)) >= 12
    assert (tmp_path / 'port.jsonl').read_text() == \
        (tmp_path / 'jax.jsonl').read_text()
    assert got == want and got['num_utterances'] == 6
    if not mode:
        assert got['offline_fallback'] == 6


def test_artifact_streaming_prints_what_test_py_prints(tmp_path, jax_run,
                                                       port_run, capsys):
    """test.py --artifact (streaming) on a JAX export with CMVN and the
    port's evaluate --artifact on the CPU: the same pairs, dump and JSON
    line; utterances no longer than the prime window skipped as JAX
    skips them. The port's own artifact of its run streams too, and so
    does a QuartzNet model without --lookahead-frames (StreamingJasper;
    held to test.py in tests/test_torch_jasper_serving.py)."""
    import test as test_cli
    run, manifest, _, _ = jax_run
    art = _jax_export(run, str(tmp_path / 'art'), '--cmvn-manifest',
                      manifest)
    for chunk in ('16', '32'):
        common = ['--artifact', art, '--test-manifest', manifest,
                  '--print-all', '--streaming-chunk-frames', chunk]
        assert test_cli.main([*common, '--dump-jsonl',
                              str(tmp_path / 'jax.jsonl')]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        want = json.loads(out[-1])
        got, got_lines, _ = _run_cli([*common, '--device', 'cpu',
                                      '--dump-jsonl',
                                      str(tmp_path / 'port.jsonl')], capsys)
        assert _print_lines(got_lines) == _print_lines(out[:-1])
        assert (tmp_path / 'port.jsonl').read_text() == \
            (tmp_path / 'jax.jsonl').read_text()
        assert got == want and got['streaming']
    assert want['skipped_below_prime'] > 0 and want['num_utterances'] > 0
    from wav2letter_pytorch_tpu_torch import export_serving as export_cli
    prun, pmanifest, lm = port_run
    part = str(tmp_path / 'port_art')
    assert export_cli.main(['--model-path', prun, '--out', part,
                            '--cmvn-manifest', pmanifest, '--lm-path', lm,
                            '--device', 'cpu']) == 0
    got, _, _ = _run_cli(['--artifact', part, '--test-manifest', pmanifest,
                          '--streaming-chunk-frames', '16', '--device',
                          'cpu'], capsys)
    assert got['num_utterances'] + got['skipped_below_prime'] == 6
    assert got['weights'] == 'f32' and 'decode' not in got
    got, _, _ = _run_cli(['--test-manifest', pmanifest, '--device', 'cpu',
                          '--streaming', '--streaming-chunk-frames', '16',
                          'model=quartznet', 'model.mid_layers=1',
                          'model.jasper_blocks.0.layer_size=16'], capsys)
    assert got['streaming'] and got['weights'] == 'f32'
    assert got['num_utterances'] == 6 and got['offline_fallback'] == 0
