"""Quantization-aware finetuning: the port's ``serving/qat.py``,
``optim.Lamb`` / ``optim.Adam`` and the ``qat_finetune`` CLI vs the JAX
package's ``serving/qat.py``, optax and ``scripts/qat_finetune.py``.

The model is the JAX serving tests' small Wav2Letter (``tests/
test_streaming.py::SMALL_LAYERS``: 3 layers of width 12 over 8 mel bands,
BatchNorm statistics perturbed so the fold does work). Inputs come from
seeded numpy; the port runs on the CPU (the plain CTC and frontend).
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_streaming import N_MELS, SMALL_LAYERS, _build
from tests.test_train_e2e import _make_corpus
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.serving import qat as jqat
from wav2letter_pytorch_tpu.training.trainer import \
    masked_ctc_mean as jax_masked_ctc_mean
from wav2letter_pytorch_tpu_torch import export_serving as export_cli
from wav2letter_pytorch_tpu_torch import optim
from wav2letter_pytorch_tpu_torch import qat_finetune as qat_cli
from wav2letter_pytorch_tpu_torch import serving
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.serving import qat
from wav2letter_pytorch_tpu_torch.training.trainer import masked_ctc_mean

torch.set_num_threads(1)

# Float32 convs summed in another order: log-probs agree to ~2.4e-7 of max
# |log p|. A fake-quant grid point flipped on a rounding tie would show as
# ~1e-2 and fail.
LOGP_RTOL = 1e-5
# The int8 graph sums int32 exactly; the fake-quant float32 conv sums the
# same products with float rounding (the JAX test's bars).
Q8_ATOL, Q8_RTOL = 5e-3, 1e-3
GRAD_RTOL = 1e-4            # of each tensor's largest gradient entry
OPT_RTOL = 1e-6             # of each tensor's largest entry, after 5 steps
FINETUNE_RTOL = 1e-4        # of each tensor's largest entry, after 3 steps


@pytest.fixture(scope='module')
def small():
    """(JAX frontend, f32 fold, static activation scales, the port's
    frontend)."""
    _, variables, frontend = _build(SMALL_LAYERS)
    folded = jserve.fold_batchnorm(variables, len(SMALL_LAYERS))
    folded = [(np.asarray(w), np.asarray(b)) for w, b in folded]
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32)
    scales = jserve.calibrate_activation_scales(
        SMALL_LAYERS, folded, frontend, audio, np.array([24000, 20000]))
    port_fe = SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0)
    return frontend, folded, scales, port_fe


def _feats(frontend, lengths, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((len(lengths), max(lengths))) * 0.1) \
        .astype(np.float32)
    for b, L in enumerate(lengths):
        audio[b, L:] = 0.0
    feats, flens = frontend(audio, np.asarray(lengths))
    return np.array(feats), np.array(flens)


def _tensors(folded, grad=False):
    return [tuple(torch.tensor(np.asarray(a), requires_grad=grad)
                  for a in wb) for wb in folded]


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    B, L = 2, 24000
    return dict(audio=(rng.standard_normal((B, L)) * 0.1).astype(np.float32),
                audio_lengths=np.array([L, L - 3200], np.int32),
                targets=rng.integers(1, 7, (B, 6)).astype(np.int32),
                target_lengths=np.array([6, 5], np.int32),
                batch_mask=np.ones((B,), np.float32))


def _close_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def test_fake_quant_weight_is_quantize_folded(small):
    """The fake-quant values are quantize_folded's q * scale, bit for bit,
    in both packages."""
    _, folded, _, _ = small
    for (w, b), (q, scale, _) in zip(folded, serving.quantize_folded(folded)):
        got = qat.fake_quant_weight(torch.from_numpy(w.copy())).numpy()
        want = np.asarray(jqat.fake_quant_weight(w))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, q.astype(np.float32) * scale[None, None, :])


@pytest.mark.parametrize('seed', [0, 1])
def test_ste_gradients_match_jax(seed):
    """Straight-through gradients as jax.grad gives them: 1 inside the
    range, 0 where activations clip, and 0.5 on every per-channel max
    weight, which lands on +-127 exactly (the tie of min / max)."""
    x = np.array([0.4, -3.2, 500.0, -500.0, 1.0, 127.0, -127.4], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    qat.fake_quant_act(xt, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jqat.fake_quant_act(v, 1.0)))(x)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy()[:5], [1, 1, 0, 0, 1])

    w = np.random.default_rng(seed).standard_normal((3, 4, 5)) \
        .astype(np.float32)
    wt = torch.tensor(w, requires_grad=True)
    qat.fake_quant_weight(wt).sum().backward()
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jqat.fake_quant_weight(v)))(jnp.asarray(w)))
    got = wt.grad.numpy()
    np.testing.assert_array_equal(got, want)
    at_max = np.abs(w) == np.abs(w).max(axis=(0, 1), keepdims=True)
    assert at_max.sum() == 5
    np.testing.assert_array_equal(got[at_max], 0.5)
    np.testing.assert_array_equal(got[~at_max], 1.0)


@pytest.mark.parametrize('scales, f32_layers', [
    ('static', ()), ('dynamic', ()), ('static', (1, 'head')),
    ('dynamic', (0, 2)), ('dynamic', (0, 1, 2, 'head'))])
@pytest.mark.parametrize('padding_mode', ['reflect', 'zeros'])
def test_qat_forward_matches_jax(small, scales, f32_layers, padding_mode):
    frontend, folded, act_scales, _ = small
    act_scales = act_scales if scales == 'static' else None
    feats, flens = _feats(frontend, [24000, 20800])
    want, want_lens = jqat.qat_forward(
        SMALL_LAYERS, folded, feats, flens, act_scales=act_scales,
        padding_mode=padding_mode, f32_layers=f32_layers)
    got, got_lens = qat.qat_forward(
        SMALL_LAYERS, _tensors(folded), torch.from_numpy(feats),
        torch.from_numpy(flens), act_scales=act_scales,
        padding_mode=padding_mode, f32_layers=f32_layers)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    _close_rel(got.detach().numpy(), want, LOGP_RTOL)


@pytest.mark.parametrize('scales', ['static', 'dynamic'])
def test_qat_forward_matches_int8_graph(small, scales):
    """qat_forward reproduces the port's offline_forward_q8 within the JAX
    test's bars; its int32 sums make it the same bits."""
    frontend, folded, act_scales, _ = small
    act_scales = act_scales if scales == 'static' else None
    feats, flens = _feats(frontend, [24000, 16000])
    f, fl = torch.from_numpy(feats), torch.from_numpy(flens)
    want, want_lens = serving.offline_forward_q8(
        SMALL_LAYERS, serving.quantize_folded(folded), f, fl,
        act_scales=act_scales)
    got, got_lens = qat.qat_forward(SMALL_LAYERS, _tensors(folded), f, fl,
                                    act_scales=act_scales)
    assert torch.equal(got_lens, want_lens)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=Q8_ATOL, rtol=Q8_RTOL)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree > 0.999
    assert torch.equal(got, want)


def test_qat_forward_all_f32_is_weight_only_int8(small):
    """Every layer exempted: the weight-only int8 forward (offline_forward
    over the quantized weights) and offline_forward_q8's float32 branch."""
    frontend, folded, _, _ = small
    feats, flens = _feats(frontend, [24000])
    f, fl = torch.from_numpy(feats), torch.from_numpy(flens)
    exempt = tuple(range(len(SMALL_LAYERS))) + ('head',)
    got, _ = qat.qat_forward(SMALL_LAYERS, _tensors(folded), f, fl,
                             f32_layers=exempt)
    q = serving.quantize_folded(folded)
    for want, _ in (serving.offline_forward(SMALL_LAYERS, q, f, fl),
                    serving.offline_forward_q8(SMALL_LAYERS, q, f, fl,
                                               f32_layers=exempt)):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


def _jax_loss_and_grads(folded, frontend, batch, act_scales):
    def loss_fn(p):
        feats, flens = frontend(batch['audio'], batch['audio_lengths'])
        logp, out_lens = jqat.qat_forward(SMALL_LAYERS, p, feats, flens,
                                          act_scales=act_scales)
        return jax_masked_ctc_mean(logp, out_lens, batch['targets'],
                                   batch['target_lengths'],
                                   batch['batch_mask'])
    params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in folded]
    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize('scales', ['static', 'dynamic'])
def test_loss_gradients_match_jax(small, scales):
    frontend, folded, act_scales, port_fe = small
    act_scales = act_scales if scales == 'static' else None
    batch = _batch()
    want_loss, want_grads = _jax_loss_and_grads(folded, frontend, batch,
                                                act_scales)
    params = qat.init_params(folded, 'cpu')
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        feats, flens = port_fe(tb['audio'], tb['audio_lengths'])
    logp, out_lens = qat.qat_forward(SMALL_LAYERS, params, feats, flens,
                                     act_scales=act_scales)
    loss = masked_ctc_mean(logp, out_lens, tb['targets'],
                           tb['target_lengths'], tb['batch_mask'])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for got_wb, want_wb in zip(params, want_grads):
        for t, g in zip(got_wb, want_wb):
            _close_rel(t.grad.numpy(), g, GRAD_RTOL)


@pytest.mark.parametrize('name', ['lamb', 'adam'])
def test_optimizer_matches_optax(name):
    """5 steps on seeded gradients, per-tensor trust ratios on leaves of
    several shapes, one of them all zeros (trust ratio 1)."""
    rng = np.random.default_rng(11)
    shapes = [(5, 4, 3), (3,), (1, 3, 7), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p0[1][:] = 0.0
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = optax.lamb(3e-3) if name == 'lamb' else optax.adam(3e-3)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = (optim.Lamb if name == 'lamb' else optim.Adam)(tp, lr=3e-3)
    for gs in grads:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, g in zip(tp, gs):
            t.grad = torch.from_numpy(g.copy())
        opt.step()
        for t, want in zip(tp, jp):
            _close_rel(t.detach().numpy(), want, OPT_RTOL)


@pytest.mark.parametrize('scales', ['static', 'dynamic'])
@pytest.mark.parametrize('optimizer', ['lamb', 'adam'])
def test_qat_finetune_matches_jax(small, scales, optimizer):
    """Three steps from the same fold on the same batches: QAT draws no
    random numbers, so the folds agree to float32 rounding."""
    frontend, folded, act_scales, port_fe = small
    act_scales = act_scales if scales == 'static' else None
    batches = [_batch(3), _batch(4)]
    kw = dict(act_scales=act_scales, steps=3, learning_rate=3e-3,
              optimizer=optimizer, log_every=1)
    want, want_hist = jqat.qat_finetune(SMALL_LAYERS, folded, frontend,
                                        batches, **kw)
    got, got_hist = qat.qat_finetune(SMALL_LAYERS, folded, port_fe, batches,
                                     **kw)
    assert [s for s, _ in got_hist] == [s for s, _ in want_hist] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got_hist],
                               [v for _, v in want_hist], rtol=1e-5)
    for got_wb, want_wb in zip(got, want):
        for g, w in zip(got_wb, want_wb):
            assert isinstance(g, np.ndarray) and g.dtype == np.float32
            _close_rel(g, w, FINETUNE_RTOL)


def test_qat_finetune_improves_int8_loss(small):
    """40 LAMB steps at 3e-3 on one batch lower the CTC loss of the int8
    graph that serving runs (offline_forward_q8 over quantize_folded)."""
    _, folded, act_scales, port_fe = small
    batch = _batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def int8_loss(fold):
        with torch.no_grad():
            feats, flens = port_fe(tb['audio'], tb['audio_lengths'])
            logp, out_lens = serving.offline_forward_q8(
                SMALL_LAYERS, serving.quantize_folded(fold), feats, flens,
                act_scales=act_scales)
            return masked_ctc_mean(logp, out_lens, tb['targets'],
                                   tb['target_lengths'],
                                   tb['batch_mask']).item()
    before = int8_loss(folded)
    new_folded, history = qat.qat_finetune(
        SMALL_LAYERS, folded, port_fe, [batch], act_scales=act_scales,
        steps=40, learning_rate=3e-3, log_every=10)
    after = int8_loss(new_folded)
    assert [s for s, _ in history] == [10, 20, 30, 40]
    assert after < before, (before, after)
    for (w0, b0), (w1, b1) in zip(folded, new_folded):
        assert w1.shape == w0.shape and b1.shape == b0.shape


def test_unknown_optimizer_raises(small):
    _, folded, _, port_fe = small
    with pytest.raises(ValueError, match='unknown optimizer'):
        qat.qat_finetune(SMALL_LAYERS, folded, port_fe, [_batch()], steps=1,
                         optimizer='sgd')


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """A tiny port run (2 epochs over 6 short utterances) and its int8
    artifact with CMVN and calibrated activation scales."""
    from wav2letter_pytorch_tpu_torch import train as port_train
    root = tmp_path_factory.mktemp('qat_run')
    manifest = _make_corpus(root)
    run = str(root / 'run')
    assert port_train.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        'data.batch_size=2', 'data.num_length_buckets=1',
        'model.input_size=32', 'model.layers.0.output_size=24',
        'model.layers.0.kernel_size=7', 'trainer.max_epochs=2',
        f'trainer.default_root_dir={run}', '--device', 'cpu']) == 0
    art = str(root / 'artifact_int8')
    assert export_cli.main([
        '--model-path', run, '--out', art, '--int8', '--cmvn-manifest',
        manifest, '--calibrate', '--calibrate-clips', '4', '--device',
        'cpu']) == 0
    return run, manifest, art


@pytest.mark.parametrize('flags', [[], ['--norm', 'cmvn', '--opt', 'adam',
                                        '--f32-layers', '0,head']])
def test_cli_artifact_is_quantize_folded_of_the_new_fold(
        port_run, tmp_path, capsys, monkeypatch, flags):
    """The CLI's artifact loads in the JAX package, its int8 weights are
    JAX's quantize_folded of the fold QAT returned, bit for bit, and its
    CMVN, scales and metadata are the source artifact's; the report has
    the JAX script's keys."""
    run, manifest, art = port_run
    captured = []
    finetune = qat.qat_finetune

    def capture(*args, **kwargs):
        out = finetune(*args, **kwargs)
        captured.append(out[0])
        return out
    monkeypatch.setattr(qat, 'qat_finetune', capture)
    out = str(tmp_path / 'qat_art')
    assert qat_cli.main([
        '--model-path', run, '--from-artifact', art, '--train-manifest',
        manifest, '--out', out, '--steps', '3', '--batch-size', '2',
        '--log-every', '2', '--eval-manifest', manifest, '--device', 'cpu',
        *flags]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {'steps', 'lr', 'opt', 'norm', 'batch_size',
                           'f32_layers', 'before', 'history', 'after',
                           'artifact'}
    assert report['artifact'] == out and report['steps'] == 3
    assert [h[0] for h in report['history']] == [2, 3]
    assert report['f32_layers'] == (['0', 'head'] if flags else [])
    for key in ('before', 'after'):
        assert set(report[key]) == {'cer', 'wer'}
    meta, folded_q, stats = jserve.load_serving(out)
    src_meta, _, src_stats = jserve.load_serving(art)
    assert meta['format'] == 'int8'
    assert meta['act_scales'] == src_meta['act_scales']
    assert meta['layers'] == src_meta['layers']
    for u, v in zip(stats, src_stats):
        np.testing.assert_array_equal(u, v)
    (new_fold,) = captured
    want = jserve.quantize_folded(new_fold)
    assert len(folded_q) == len(want) == 2
    for g, w in zip(folded_q, want):
        for u, v in zip(g, w):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def test_cli_refusals(port_run, tmp_path):
    run, manifest, art = port_run
    base = ['--train-manifest', manifest, '--out', str(tmp_path / 'x'),
            '--steps', '1', '--device', 'cpu']
    f32 = str(tmp_path / 'artifact_f32')
    assert export_cli.main(['--model-path', run, '--out', f32, '--device',
                            'cpu']) == 0
    with pytest.raises(SystemExit, match='no act_scales'):
        qat_cli.main(['--model-path', run, '--from-artifact', f32, *base])
    jasper = tmp_path / 'jasper_run'
    jasper.mkdir()
    cfg = load_config(['data.train_manifest=-', 'data.val_manifest=-',
                       'model=quartznet'])
    (jasper / 'config.json').write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match='wav2letter family'):
        qat_cli.main(['--model-path', str(jasper), '--from-artifact', art,
                      *base])
    no_cmvn = str(tmp_path / 'artifact_no_cmvn')
    meta, folded, _ = serving.load_serving(art)
    serving.export_serving(
        no_cmvn, meta['layers'], meta['num_labels'], None,
        labels=meta['labels'], audio_conf=meta['audio_conf'],
        weights='f32', act_scales=meta['act_scales'],
        folded=[(q.astype(np.float32) * s[None, None, :], b)
                for q, s, b in folded])
    with pytest.raises(SystemExit, match='no CMVN stats'):
        qat_cli.main(['--model-path', run, '--from-artifact', no_cmvn,
                      '--norm', 'cmvn', *base])
    assert not os.path.exists(str(tmp_path / 'x'))


def test_cli_needs_the_card_unless_asked_for_the_cpu(port_run, tmp_path,
                                                     monkeypatch):
    run, manifest, art = port_run
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        qat_cli.main(['--model-path', run, '--from-artifact', art,
                      '--train-manifest', manifest, '--out',
                      str(tmp_path / 'x')])
