"""The kernel-selection knobs of the port, ``trainer.ctc_impl`` and
``model.stft_method``, against the JAX package on the CPU.

JAX documents ``ctc_impl: auto | scan | pallas`` (``configs/config.yaml``;
``training/trainer.py``) and ``stft_method: auto | pallas | conv | matmul |
fft`` (``training/build.py``, ``data/features.py``). In the port
``pallas`` selects the hand kernels (K2/K3, K1; their plain versions on a
CPU tensor), ``scan`` the plain CTC (``ops/ctc.py``) and ``conv`` /
``matmul`` / ``fft`` the one plain dense-DFT frontend, on any device;
``auto`` is what the port did before the knobs.

* every documented value is accepted and selects its path, any other
  raises, and the TPU mechanisms stay refused;
* ``ctc_impl=scan`` and ``=pallas``: the same loss and gradient
  (``tests/test_torch_ctc.py``'s and ``test_torch_ctc_grad.py``'s gates)
  and the same train step;
* the port's ``conv``, ``matmul`` and ``fft`` features against JAX's
  ``SpectrogramFrontend`` with that method, at JAX's own tolerance
  (rtol = atol = 1e-3, ``tests/test_features.py``);
* ``pallas`` outside K1's n_fft range raises;
* a JAX run whose config says ``stft_method: pallas`` and ``ctc_impl:
  pallas`` (as one written for a TPU does) imports and evaluates in the
  port with ``--cpu``, as ``test.py`` scores it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_evaluate import JAX_RUN_OVERRIDES, LOSS_RTOL
from tests.test_torch_frontend import _batch
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import import_torch_checkpoint
from wav2letter_pytorch_tpu_torch.config import CHOICES, load_config
from wav2letter_pytorch_tpu_torch.data import features
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.ops.ctc import ctc_loss
from wav2letter_pytorch_tpu_torch.ops.ctc_kernel import ctc_loss_kernel
from wav2letter_pytorch_tpu_torch.training import trainer as trainer_mod
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model)
from wav2letter_pytorch_tpu_torch.training.trainer import (CTC_IMPLS,
                                                           Trainer,
                                                           masked_ctc_mean)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ['data.train_manifest=x', 'data.val_manifest=y']
# tests/test_torch_ctc.py (loss) and tests/test_torch_ctc_grad.py
# (gradient): the CTC gates
CTC_RTOL, CTC_ATOL, GRAD_ATOL = 1e-5, 1e-4, 1e-4
# JAX's tolerance between its STFT methods (tests/test_features.py)
METHOD_TOL = 1e-3
TINY_W2L = ['model.input_size=16', 'model.mid_layers=2',
            'model.layers=[{output_size: 16, kernel_size: 7, stride: 2, '
            'dilation: 1, dropout: -1.0}, {output_size: 16, kernel_size: 5, '
            'stride: 1, dilation: 1, dropout: -1.0}]']


def _trainer(overrides, tmp_path, init=None):
    cfg = load_config(BASE + TINY_W2L + list(overrides))
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    if init is not None:
        model.load_state_dict(init)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    return Trainer(cfg, model, build_frontend(cfg['model'], dither=0.0),
                   opt, lambda _: 0.05, GreedyDecoder(labels), device='cpu',
                   run_dir=str(tmp_path))


@pytest.mark.parametrize('key,value', [
    ('trainer.ctc_impl', v) for v in CHOICES['trainer.ctc_impl']] + [
    ('model.stft_method', v) for v in CHOICES['model.stft_method']])
def test_every_documented_value_is_taken(key, value, tmp_path):
    """Each JAX value loads and selects its path: the trainer's CTC
    (``CTC_IMPLS``) and the frontend's method."""
    tr = _trainer([f'{key}={value}'], tmp_path)
    if key == 'trainer.ctc_impl':
        assert tr.ctc is (ctc_loss if value == 'scan' else ctc_loss_kernel)
    else:
        assert tr.frontend.stft_method == value
    assert set(CHOICES['trainer.ctc_impl']) == {'auto', 'scan', 'pallas'}
    assert set(CHOICES['model.stft_method']) == {'auto', 'pallas', 'conv',
                                                 'matmul', 'fft'}


@pytest.mark.parametrize('override,match', [
    ('trainer.ctc_impl=cudnn', 'trainer.ctc_impl must be one of'),
    ('trainer.ctc_impl=Pallas', 'trainer.ctc_impl must be one of'),
    ('model.stft_method=stft', 'model.stft_method must be one of'),
    ('model.stft_method=null', 'model.stft_method must be one of'),
    ('trainer.steps_per_dispatch=4', 'not supported'),
    ('trainer.device_cache=true', 'not supported'),
    ('trainer.host_rss_budget_gb=26', 'not supported'),
    ('trainer.prng_impl=threefry', 'not supported')])
def test_other_values_and_the_tpu_mechanisms_raise(override, match):
    with pytest.raises(ValueError, match=match):
        load_config(BASE + [override])


def test_ctc_scan_matches_pallas():
    """``masked_ctc_mean`` through the plain CTC (``scan``) and through
    the kernel path (``pallas``: K2/K3's plain versions here): loss and
    gradient at the CTC tests' gates, ragged lengths, a masked row."""
    rng = np.random.default_rng(0)
    B, T, L, S = 4, 30, 29, 8
    logits = torch.from_numpy(rng.standard_normal((B, T, L)).astype(
        np.float32))
    lens = torch.tensor([30, 24, 17, 30], dtype=torch.int32)
    targets = torch.from_numpy(rng.integers(1, L, (B, S)).astype(np.int32))
    tlens = torch.tensor([8, 5, 3, 6], dtype=torch.int32)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    out = {}
    for impl in ('scan', 'pallas'):
        lp = torch.log_softmax(logits, -1).detach().requires_grad_()
        loss = masked_ctc_mean(lp, lens, targets, tlens, mask,
                               ctc=CTC_IMPLS[impl])
        loss.backward()
        out[impl] = (float(loss.detach()), lp.grad.numpy())
    assert out['scan'][0] == pytest.approx(out['pallas'][0], rel=CTC_RTOL,
                                           abs=CTC_ATOL)
    np.testing.assert_allclose(out['scan'][1], out['pallas'][1], rtol=0,
                               atol=GRAD_ATOL)
    assert np.abs(out['pallas'][1]).max() > 1e-2


def test_train_and_eval_steps_with_scan_match_pallas(tmp_path):
    """One train step and one eval step of the same weights with
    ``trainer.ctc_impl=scan`` and ``=pallas``: the losses within the CTC
    gate, the updated weights within it too."""
    from tests.torch_parallel_worker import invariance_batch
    batch = {k: torch.from_numpy(v) for k, v in
             invariance_batch(B=4, t=4800).items()}
    init = _trainer([], tmp_path / 'init').model.state_dict()
    got = {}
    for impl in ('scan', 'pallas'):
        tr = _trainer([f'trainer.ctc_impl={impl}'], tmp_path / impl, init)
        tr.model.eval()
        eval_loss = float(trainer_mod.eval_step(tr.model, tr.frontend, batch,
                                                ctc=tr.ctc)[0])
        loss = float(tr.train_step(batch)[0])
        got[impl] = (eval_loss, loss, tr.model.state_dict())
        tr.close()
    for i in (0, 1):
        assert got['scan'][i] == pytest.approx(got['pallas'][i],
                                               rel=CTC_RTOL, abs=CTC_ATOL)
    for k, v in got['pallas'][2].items():
        if v.is_floating_point():
            np.testing.assert_allclose(got['scan'][2][k].numpy(), v.numpy(),
                                       rtol=CTC_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize('method', ['conv', 'matmul', 'fft'])
def test_plain_methods_match_jax_methods(method, monkeypatch):
    """The port's ``conv``, ``matmul`` and ``fft`` (the plain dense DFT,
    no K1) against JAX's frontend with the same method: raw log-mel and
    normalised features at rtol = atol = 1e-3."""
    audio, lens = _batch(16000, seed=3)
    ref, ref_lens = JaxFrontend(JaxAudio(), n_mels=64, stft_method=method,
                                dither=0.0)(audio, lens)
    raw_ref, _ = JaxFrontend(JaxAudio(), n_mels=64, stft_method=method,
                             dither=0.0, normalize=False)(audio, lens)

    def no_k1(*args, **kw):
        raise AssertionError(f'stft_method={method} reached K1')
    monkeypatch.setattr(features, 'stft_mel_log', no_k1)
    fe = SpectrogramFrontend(AudioConfig(), n_mels=64, dither=0.0,
                             stft_method=method)
    raw_fe = SpectrogramFrontend(AudioConfig(), n_mels=64, dither=0.0,
                                 stft_method=method, normalize=False)
    a, l = torch.from_numpy(audio), torch.from_numpy(lens)
    with torch.no_grad():
        ours, our_lens = fe(a, l)
        raw, _ = raw_fe(a, l)
    np.testing.assert_array_equal(our_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_ref),
                               rtol=METHOD_TOL, atol=METHOD_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=METHOD_TOL, atol=METHOD_TOL)


@pytest.mark.parametrize('method,k1', [('auto', True), ('pallas', True),
                                       ('conv', False), ('fft', False)])
def test_which_methods_reach_k1(method, k1, monkeypatch):
    """``auto`` and ``pallas`` go through K1's wrapper (its plain version
    on this CPU tensor), the plain methods never."""
    calls = []
    real = features.stft_mel_log

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(features, 'stft_mel_log', spy)
    audio, lens = _batch(16000)
    SpectrogramFrontend(AudioConfig(), n_mels=64, stft_method=method)(
        torch.from_numpy(audio), torch.from_numpy(lens))
    assert bool(calls) == k1


@pytest.mark.parametrize('window_size', [0.002, 0.4])
def test_pallas_outside_k1_range_raises(window_size):
    """n_fft 32 and 8 192: K1 takes powers of two in [64, 4096], so an
    explicit ``pallas`` raises when the frontend is built; ``auto`` and
    ``conv`` build (on the card ``auto`` raises at K1's launch)."""
    conf = AudioConfig(window_size=window_size, window_stride=0.001)
    with pytest.raises(ValueError, match='n_fft a power of two'):
        SpectrogramFrontend(conf, n_mels=16, stft_method='pallas')
    for method in ('auto', 'conv'):
        SpectrogramFrontend(conf, n_mels=16, stft_method=method)
    cfg = load_config(BASE + ['model.stft_method=pallas',
                              f'model.audio_conf.window_size={window_size}'])
    with pytest.raises(ValueError, match='n_fft a power of two'):
        build_frontend(cfg['model'])


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A tiny JAX run (``tests/test_torch_evaluate.py``'s) exported with
    ``scripts/export_torch_checkpoint.py``."""
    import train as jax_train
    from tests.test_train_e2e import _make_corpus
    root = tmp_path_factory.mktemp('knobs_jax_run')
    manifest = _make_corpus(root)
    run = root / 'run'
    assert jax_train.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        'data.batch_size=2', 'data.num_length_buckets=1',
        'model.input_size=32',
        'model.layers=[{output_size: 24, kernel_size: 7, stride: 2, '
        'dilation: 1, dropout: 0.1}]',
        'trainer.max_epochs=1', 'trainer.max_steps=2',
        'trainer.string_metrics_interval=0', 'trainer.mesh.data=1',
        f'trainer.default_root_dir={run}']) == 0
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import export_torch_checkpoint
    finally:
        sys.path.remove(os.path.join(REPO, 'scripts'))
    export = str(root / 'export.ckpt')
    assert export_torch_checkpoint.main(['--model-path', str(run), '--out',
                                         export]) == 0
    return str(run), str(manifest), export


def test_jax_run_with_tpu_knobs_evaluates_in_port(jax_run, tmp_path,
                                                  capsys):
    """The JAX run's config restated with ``model.stft_method=pallas`` and
    ``trainer.ctc_impl=pallas`` (a config written for a TPU) imports into
    a port run (``import_torch_checkpoint``), whose ``config.json`` keeps
    both, and ``evaluate.main --model-path ... --cpu`` scores it as
    ``test.py`` scores the JAX run: WER and CER equal, the loss within
    ``tests/test_torch_evaluate.py``'s LOSS_RTOL."""
    import test as test_cli
    run, manifest, export = jax_run
    knobs = ['model.stft_method=pallas', 'trainer.ctc_impl=pallas']
    port_run = str(tmp_path / 'port_run')
    assert import_torch_checkpoint.main(
        ['--ckpt', export, '--out', port_run, *JAX_RUN_OVERRIDES,
         *knobs]) == 0
    with open(os.path.join(port_run, 'config.json')) as f:
        cfg = json.load(f)
    assert cfg['model']['stft_method'] == 'pallas'
    assert cfg['trainer']['ctc_impl'] == 'pallas'
    capsys.readouterr()
    assert test_cli.main(['--model-path', run, '--test-manifest',
                          manifest]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_eval.main(['--model-path', port_run, '--test-manifest',
                           manifest, '--cpu']) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got['num_utterances'] == want['num_utterances'] > 0
    assert (got['wer'], got['cer']) == (want['wer'], want['cer'])
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL)
