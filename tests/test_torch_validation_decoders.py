"""Training-time validation with a beam ``model.decoder`` in the port,
against the JAX trainer on the CPU.

The JAX package's ``build_decoder`` instantiates any of its decoder targets
(``config.py``'s registry: ``GreedyDecoder``, ``PrefixBeamSearchLMDecoder``
and ``DeviceBeamDecoder`` under the JAX names, the first two also under
the reference's), and its ``validate`` decodes the eval step's outputs with
``decoder.decode(out, sizes)`` unless the decoder is exactly a
``GreedyDecoder``. The port does the same with one difference, ROADMAP
C.6: Wav2Letter's eval emits log-probs, which the JAX trainer hands to the
beam decoder as if they were probabilities; the port takes their ``exp``,
as the JAX package's own ``test.py`` does.

* the five target names resolve to the port's classes, an unknown one
  raises;
* ``val_wer`` / ``val_cer`` with ``PrefixBeamSearchLMDecoder`` (without
  and with an ARPA LM from ``build_arpa`` on the transcripts) and with
  ``DeviceBeamDecoder``, on the same weights: Jasper's equal the JAX
  trainer's; Wav2Letter's equal JAX's decoder applied to ``exp`` of the
  outputs, and the JAX trainer is shown to feed its decoder log-probs;
* ``train.main`` with a beam decoder end to end with ``--cpu``, in one
  process and on two data-parallel ranks (each decodes its rows, the
  sums reduced): the same validation metrics.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_bf16 import _flow
from tests.test_torch_parallel import _argv, _launch, _metrics
from tests.test_train_e2e import _make_corpus
from wav2letter_pytorch_tpu.config import load_config as jax_load_config
from wav2letter_pytorch_tpu.data.dataset import \
    BucketBatchLoader as JaxLoader
from wav2letter_pytorch_tpu.data.dataset import \
    ManifestDataset as JaxDataset
from wav2letter_pytorch_tpu.training import Trainer as JaxTrainer
from wav2letter_pytorch_tpu.training import build as jax_build
from wav2letter_pytorch_tpu_torch import build_arpa
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import DECODERS, load_config
from wav2letter_pytorch_tpu_torch.data.dataset import (BucketBatchLoader,
                                                       ManifestDataset)
from wav2letter_pytorch_tpu_torch.decoding.beam_device import \
    DeviceBeamDecoder
from wav2letter_pytorch_tpu_torch.decoding.decoder import (
    GreedyDecoder, PrefixBeamSearchLMDecoder)
from wav2letter_pytorch_tpu_torch.training.build import (build_decoder,
                                                         build_frontend,
                                                         build_labels,
                                                         build_model)
from wav2letter_pytorch_tpu_torch.training.trainer import Trainer
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

SR = 16000
JAX_NAME = 'wav2letter_pytorch_tpu.decoding.'
# The two val_loss computations (JAX's scan CTC, the port's K2 plain
# version) and forwards (XLA, ATen) differ by float32 rounding.
VAL_LOSS_RTOL = 1e-4
# train.main on two ranks against one process (tests/test_torch_parallel.py)
RUN_RTOL = 1e-5
# A sharper head (x30) and a random head bias make the random models'
# outputs decisive, so that float32 differences between the two forwards
# break no near-tie in a search (tests/test_torch_evaluate.py does so for
# the greedy strings).
HEAD_SCALE = 30.0
W2L = ['model.input_size=32', 'model.mid_layers=2',
       'model.layers=' + _flow([
           dict(output_size=24, kernel_size=7, stride=2, dilation=1,
                dropout=-1.0),
           dict(output_size=24, kernel_size=5, stride=1, dilation=1,
                dropout=-1.0)])]
JASPER_BLOCKS = [
    dict(layer_size=16, kernel_size=11, stride=2, residual=False,
         separable=True),
    dict(layer_size=16, kernel_size=7, repeat=2, residual=True,
         separable=True),
    dict(layer_size=24, kernel_size=1, residual=False, separable=False)]
JASPER = ['model=quartznet', 'model.input_size=32', 'model.mid_layers=3',
          'model.jasper_blocks=' + _flow(JASPER_BLOCKS)]
FAMILIES = {'wav2letter': W2L, 'jasper': JASPER}


def _decoder(kind, lm=None) -> list:
    """``model.decoder`` overrides of a beam decoder: ``beam`` and
    ``beam_lm`` the host search (no LM, an LM), ``device`` the device
    search; k = 8."""
    if kind == 'device':
        return [f'model.decoder._target_={JAX_NAME}DeviceBeamDecoder',
                '+model.decoder.k=8']
    return [f'model.decoder._target_={JAX_NAME}PrefixBeamSearchLMDecoder',
            f'+model.decoder.lm_path={lm if kind == "beam_lm" else ""}',
            '+model.decoder.k=8']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The JAX tests' tiny corpus and a 3-gram ARPA LM on its transcripts
    from the port's ``build_arpa``."""
    root = tmp_path_factory.mktemp('val_corpus')
    manifest = _make_corpus(root)
    lm = str(root / 'lm.arpa')
    assert build_arpa.main(['--manifest', manifest, '--out', lm]) == 0
    return manifest, lm


@pytest.mark.parametrize('target,cls', [
    (f'{JAX_NAME}GreedyDecoder', GreedyDecoder),
    (f'{JAX_NAME}PrefixBeamSearchLMDecoder', PrefixBeamSearchLMDecoder),
    (f'{JAX_NAME}DeviceBeamDecoder', DeviceBeamDecoder),
    ('decoder.GreedyDecoder', GreedyDecoder),
    ('decoder.PrefixBeamSearchLMDecoder', PrefixBeamSearchLMDecoder)])
def test_decoder_targets_resolve(target, cls):
    """Each JAX and reference name builds the port's decoder with the
    config's keys and the labels (a device search on the given device);
    JAX's registry has the same names."""
    extra = (['+model.decoder.lm_path='] if 'Prefix' in target else [])
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       f'model.decoder._target_={target}',
                       '+model.decoder.k=4', *extra])
    labels = build_labels(cfg['model'])
    if cls is GreedyDecoder:
        del cfg['model']['decoder']['k']
    dec = build_decoder(cfg['model'], labels, device='cpu')
    assert type(dec) is cls
    assert list(dec.labels) == list(labels)
    if cls is not GreedyDecoder:
        assert dec.k == 4
    if cls is DeviceBeamDecoder:
        assert dec.device == torch.device('cpu')
    from wav2letter_pytorch_tpu.config import resolve_target
    assert resolve_target(target).__name__ == cls.__name__
    assert len(DECODERS) == 5


def test_unknown_decoder_target_raises():
    with pytest.raises(ValueError, match='not a decoder'):
        load_config(['data.train_manifest=x', 'data.val_manifest=y',
                     'model.decoder._target_=decoder.BeamDecoder'])
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y'])
    cfg['model']['decoder']['_target_'] = 'decoder.BeamDecoder'
    with pytest.raises(ValueError, match='Unknown decoder'):
        build_decoder(cfg['model'], ['_', 'a'])


def _sharpened(variables, family):
    """``variables`` with the head's kernel x HEAD_SCALE and a random
    head bias (numpy, seeded)."""
    params = jax.tree_util.tree_map(np.array, variables['params'])
    head = (params[max(k for k in params if k.startswith('conv1d_'))]
            ['Conv_0'] if family == 'wav2letter' else params['head'])
    rng = np.random.default_rng(5)
    head['kernel'] = head['kernel'] * HEAD_SCALE
    head['bias'] = rng.normal(0.0, 1.0, head['bias'].shape).astype(
        np.float32)
    return params


def _validations(family, kind, manifest, lm, tmp_path):
    """The JAX trainer's and the port trainer's ``validate`` on the same
    (sharpened) weights with the decoder of ``kind``; also what JAX's
    decoder was fed, batch by batch, and the JAX loader's batches."""
    overrides = [f'data.train_manifest={manifest}',
                 f'data.val_manifest={manifest}', 'data.batch_size=2',
                 *FAMILIES[family], *_decoder(kind, lm)]
    jcfg = jax_load_config(overrides + ['model.stft_method=conv',
                                        'trainer.mesh.data=1'])
    labels = jax_build.build_labels(jcfg.model)
    tx, sched = jax_build.build_optimizer(jcfg.model, 1, 10)
    jdec = jax_build.build_decoder(jcfg.model, labels)
    jtr = JaxTrainer(jcfg, jax_build.build_model(jcfg.model, len(labels)),
                     jax_build.build_frontend(jcfg.model, dither=0.0), tx,
                     sched, jdec, run_dir=str(tmp_path / 'jax'))
    assert not jtr.greedy_metrics

    def jax_loader():
        return JaxLoader(JaxDataset(manifest, {'sample_rate': SR}, labels),
                         2, num_buckets=1, shuffle=False, prefetch=0,
                         frame_hop=160)
    batches = list(jax_loader())
    jtr.init_state(batches[0])
    params = _sharpened(jax.device_get(
        {'params': jtr.state.params}), family)
    jtr.state = jtr.state.replace(params=params)
    fed, refused = [], []
    decode = jdec.decode

    def recorded(out, sizes=None, **kw):
        if np.ndim(out) != 3:   # the host search's own call a row
            return decode(out, sizes, **kw)
        fed.append((np.array(out), np.array(sizes)))
        try:
            return decode(out, sizes, **kw)
        except AssertionError as e:   # the host search refuses log-probs
            refused.append(str(e))
            return [''] * len(out)
    jdec.decode = recorded
    want = jtr.validate(jax_loader())
    jdec.decode = decode

    cfg = load_config(overrides)
    model = build_model(cfg['model'], len(labels))
    model.load_state_dict(state_dict_from_flax(
        {'params': params,
         'batch_stats': jax.device_get(jtr.state.batch_stats)},
        JASPER_BLOCKS if family == 'jasper' else None), strict=True)
    dec = build_decoder(cfg['model'], labels, device='cpu')
    tr = Trainer(cfg, model, build_frontend(cfg['model'], dither=0.0), None,
                 None, dec, device='cpu', run_dir=str(tmp_path / 'port'))
    assert not tr.greedy
    loader = BucketBatchLoader(ManifestDataset(manifest, SR, labels), 2,
                               shuffle=False, num_buckets=1, prefetch=0,
                               frame_hop=160)
    got = tr.validate(loader)
    tr.close()
    return got, want, fed, refused, batches, jdec


@pytest.mark.parametrize('kind', ['beam', 'beam_lm', 'device'])
@pytest.mark.parametrize('family', ['jasper', 'wav2letter'])
def test_validation_scores_match_jax(family, kind, corpus, tmp_path):
    """val_wer and val_cer of the port's ``validate`` with each beam
    decoder against the JAX trainer's on the same weights; val_loss
    within VAL_LOSS_RTOL. Jasper's eval emits probabilities and both
    decode them. Wav2Letter (C.6): the JAX trainer feeds its decoder the
    log-probs (each frame's exp sums to 1, every value <= 0), which its
    host search refuses outright and its device search scores as
    log(log p), and the port's scores are JAX's decoder on their exp."""
    manifest, lm = corpus
    got, want, fed, refused, batches, jdec = _validations(
        family, kind, manifest, lm, tmp_path)
    assert got['val_loss'] == pytest.approx(want['val_loss'],
                                            rel=VAL_LOSS_RTOL)
    if family == 'jasper':
        for out, _ in fed:   # probabilities
            np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)
        assert not refused
        assert (got['val_wer'], got['val_cer']) == (want['val_wer'],
                                                    want['val_cer'])
        return
    sums = {'val_wer': [0, 0], 'val_cer': [0, 0]}
    assert len(fed) == len(batches)
    for (out, sizes), batch in zip(fed, batches):
        assert out.max() <= 0.0
        np.testing.assert_allclose(np.exp(out).sum(-1), 1.0, atol=1e-4)
        decoded = jdec.decode(np.exp(out), sizes)
        for j, text in enumerate(batch['texts']):
            if batch['batch_mask'][j]:
                for key, fn in (('val_wer', jdec.wer_ratio),
                                ('val_cer', jdec.cer_ratio)):
                    n, d = fn(text, decoded[j])
                    sums[key][0] += n
                    sums[key][1] += d
    for key, (n, d) in sums.items():
        assert got[key] == n / d, key
    if kind == 'device':
        # the JAX trainer's own numbers, from log(log p), are not these
        assert not refused
        assert (want['val_wer'], want['val_cer']) != (got['val_wer'],
                                                      got['val_cer'])
    else:
        assert len(refused) == len(batches)
        assert all('negative' in e for e in refused)


@pytest.fixture(scope='module')
def cli_runs(corpus, tmp_path_factory):
    """``train.main`` with the device beam search and with the host beam
    search and the LM, each in one process and on two gloo ranks."""
    manifest, lm = corpus
    root = str(tmp_path_factory.mktemp('val_cli'))
    cases = {kind: _argv(manifest, '{run}', *W2L, 'data.batch_size=2',
                         'trainer.max_epochs=2', 'model.optimizer.lr=0.05',
                         'trainer.string_metrics_interval=2',
                         *_decoder(kind, lm))
             for kind in ('device', 'beam_lm')}
    _launch({'out': root, 'cases': [
        {'kind': 'train', 'name': kind,
         'argv': [a.replace('{run}', os.path.join(root, f'dp_{kind}'))
                  for a in argv] + ['trainer.mesh.data=2']}
        for kind, argv in cases.items()]}, root)
    for kind, argv in cases.items():
        assert train_cli.main([a.replace('{run}', os.path.join(
            root, f'one_{kind}')) for a in argv]) == 0
    return root


@pytest.mark.parametrize('kind', ['device', 'beam_lm'])
def test_train_main_with_a_beam_decoder(cli_runs, kind):
    """``train.main --cpu`` with a beam decoder runs end to end and logs
    its validation and train WER / CER, in one process and on two ranks
    alike (every logged metric within RUN_RTOL); the run's config keeps
    the decoder."""
    one = _metrics(os.path.join(cli_runs, f'one_{kind}'))
    two = _metrics(os.path.join(cli_runs, f'dp_{kind}'))
    for metric in ('val_loss', 'val_wer', 'val_cer', 'val_len_ratio',
                   'train_wer', 'train_cer', 'train_loss'):
        assert one[metric] and one[metric].keys() == two[metric].keys()
        for step, v in one[metric].items():
            assert two[metric][step] == pytest.approx(v, rel=RUN_RTOL,
                                                      abs=1e-12), metric
    ranks = [json.load(open(os.path.join(cli_runs, f'{kind}.rank{r}.json')))
             for r in range(2)]
    assert all(r['rc'] == 0 for r in ranks)
    with open(os.path.join(cli_runs, f'one_{kind}', 'config.json')) as f:
        target = json.load(f)['model']['decoder']['_target_']
    assert target.endswith('DeviceBeamDecoder' if kind == 'device'
                           else 'PrefixBeamSearchLMDecoder')
