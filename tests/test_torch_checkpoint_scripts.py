"""The port's checkpoint converters vs the JAX package's scripts, on the
CPU.

``import_torch_checkpoint`` and ``export_torch_checkpoint`` against
``scripts/import_torch_checkpoint.py`` and
``scripts/export_torch_checkpoint.py``: a reference-layout Lightning
``.ckpt`` imported by both packages evaluates to the same ``test.py`` /
``evaluate`` lines; the port's export loads ``strict=True`` in the JAX
import script and in ``evaluate --weights``; ``train --resume`` on an
imported run trains from its weights; a config whose optimizer cannot be
built falls back to SGD in both.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tests.test_train_e2e import _make_corpus
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import export_torch_checkpoint as port_exp
from wav2letter_pytorch_tpu_torch import import_torch_checkpoint as port_imp
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model,
                                                         build_optimizer,
                                                         load_run)
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer
from wav2letter_pytorch_tpu_torch.training.trainer import Trainer, to_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The model both packages build (the reference run's overrides).
OVERRIDES = ['model.input_size=32', 'model.mid_layers=1',
             'model.layers=[{output_size: 24, kernel_size: 7, stride: 2, '
             'dilation: 1, dropout: 0.1}]', 'data.batch_size=2',
             'data.num_length_buckets=1']
# The JAX runs' mesh: the batch of 2 over 2 of the 8 test devices.
JAX_OVERRIDES = OVERRIDES + ['trainer.mesh.data=2']
# Loss: float32 features, convs and CTC summed in other orders.
LOSS_RTOL = 1e-4


def _script(name):
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import importlib
        return importlib.import_module(name)
    finally:
        sys.path.remove(os.path.join(REPO, 'scripts'))


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A manifest of 6 short utterances and a reference-layout Lightning
    checkpoint of the OVERRIDES model: seeded weights, BatchNorm
    statistics away from their initial values."""
    root = tmp_path_factory.mktemp('ckpt')
    manifest = _make_corpus(root)
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       *OVERRIDES])
    model = build_model(cfg['model'], len(build_labels(cfg['model'])),
                        seed=3)
    rng = np.random.default_rng(3)
    sd = model.state_dict()
    for key in sd:
        if key.endswith(('running_mean', 'running_var', 'batch_norm.bias')):
            sd[key] = torch.from_numpy(
                (rng.random(sd[key].shape) * 0.5 + 0.2).astype(np.float32))
    ckpt = str(root / 'epoch=4.ckpt')
    torch.save({'epoch': 4, 'global_step': 120, 'state_dict': sd}, ckpt)
    return root, manifest, ckpt


def _test_py(args, capsys):
    import test as test_cli
    assert test_cli.main(args) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), [line for line in out[:-1] if line.startswith(
        ('reference: ', 'decoded  : '))]


def _evaluate(args, capsys):
    assert port_eval.main(args + ['--device', 'cpu']) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), [line for line in out[:-1] if line.startswith(
        ('reference: ', 'decoded  : '))]


def _same_eval(got, want):
    (g, g_lines), (w, w_lines) = got, want
    assert g_lines == w_lines and len(g_lines) == 12
    assert (g['wer'], g['cer'], g['num_utterances']) == \
        (w['wer'], w['cer'], w['num_utterances'])
    np.testing.assert_allclose(g['loss'], w['loss'], rtol=LOSS_RTOL)


@pytest.fixture(scope='module')
def imported(corpus, tmp_path_factory):
    """The checkpoint imported by each package: (port run, JAX run, the
    two summary lines)."""
    root, _, ckpt = corpus
    lines = {}
    for name, main, overrides in (
            ('port', port_imp.main, OVERRIDES),
            ('jax', _script('import_torch_checkpoint').main, JAX_OVERRIDES)):
        out = str(root / f'{name}_run')
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(['--ckpt', ckpt, '--out', out, *overrides]) == 0
        lines[name] = buf.getvalue().strip().splitlines()[-1].replace(
            out, '<out>')
    return str(root / 'port_run'), str(root / 'jax_run'), lines


def test_import_writes_a_trainer_state(imported, corpus):
    """ckpt_0.pt in Trainer.state_dict()'s layout (step 0, the reference
    weights loaded strict, a fresh SGD state, no gradients), meta
    {'epoch': 0}, config.json; the JAX script's summary line."""
    run, _, lines = imported
    _, _, ckpt = corpus
    assert lines['port'] == lines['jax']
    assert lines['port'].startswith(f'imported {ckpt} -> <out> (Wav2Letter, ')
    ck = Checkpointer(os.path.join(run, 'checkpoints'))
    assert ck.all_steps() == [0] and ck.load_extra() == {'epoch': 0}
    state = ck.restore()
    assert set(state) == {'step', 'model', 'optimizer', 'grad_accum'}
    assert state['step'] == 0 and state['grad_accum'] is None
    assert state['optimizer']['state'] == {}
    ref = torch.load(ckpt, weights_only=True)['state_dict']
    assert state['model'].keys() == ref.keys()
    for k, v in ref.items():
        torch.testing.assert_close(state['model'][k], v, rtol=0, atol=0)
    with open(os.path.join(run, 'config.json')) as f:
        cfg = json.load(f)
    assert cfg['model']['layers'][0]['output_size'] == 24


def test_imported_runs_evaluate_alike(imported, corpus, capsys):
    """test.py on the JAX package's import and evaluate on the port's: the
    same (reference, decoded) pairs, WER and CER, the loss within
    LOSS_RTOL."""
    run, jax_run, _ = imported
    _, manifest, _ = corpus
    common = ['--test-manifest', manifest, '--print-all']
    _same_eval(_evaluate(['--model-path', run, *common], capsys),
               _test_py(['--model-path', jax_run, *common], capsys))


@pytest.mark.parametrize('average_last', [None, 2])
def test_export_loads_strict_in_jax_and_in_evaluate(tmp_path, corpus,
                                                    capsys, average_last):
    """A port run (two checkpoints) exported, optionally averaged: the
    file holds the run's (averaged) model state, loads strict in JAX's
    import script (whose run then evaluates as the port run does) and in
    evaluate --weights."""
    root, manifest, _ = corpus
    run = str(tmp_path / 'run')
    assert train_cli.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        *OVERRIDES, 'trainer.max_epochs=2',
        'trainer.string_metrics_interval=0',
        f'trainer.default_root_dir={run}', '--device', 'cpu']) == 0
    capsys.readouterr()
    out = str(tmp_path / 'export.ckpt')
    flags = [] if average_last is None else ['--average-last',
                                              str(average_last)]
    assert port_exp.main(['--model-path', run, '--out', out, *flags]) == 0
    assert capsys.readouterr().out.strip() == \
        f'wrote {out} (9 tensors, step 6)'
    saved = torch.load(out, weights_only=True)
    assert saved['global_step'] == 6
    assert saved['exported_by'] == 'wav2letter_pytorch_tpu_torch'
    _, model, _, _ = load_run(run, average_last=average_last)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(saved['state_dict'][k], v, rtol=0, atol=0)
    jax_run = str(tmp_path / 'jax_run')
    assert _script('import_torch_checkpoint').main(
        ['--ckpt', out, '--out', jax_run, *JAX_OVERRIDES]) == 0
    common = ['--test-manifest', manifest, '--print-all']
    port = _evaluate(['--model-path', run, *common]
                     + ([] if average_last is None
                        else ['--average-last', str(average_last)]), capsys)
    _same_eval(_test_py(['--model-path', jax_run, *common], capsys), port)
    weights = _evaluate(['--weights', out, *common, *OVERRIDES], capsys)
    assert weights == port


def test_train_resume_on_an_imported_run(imported, corpus, tmp_path,
                                         capsys):
    """train --resume on the imported run starts from step 0 with its
    weights: the first step's loss is that of a trainer holding them (and
    not that of the seed's weights), and the run goes on from there."""
    run, _, _ = imported
    root, manifest, _ = corpus
    argv = [f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
            *OVERRIDES, 'trainer.max_steps=2', 'trainer.log_every_n_steps=1',
            'trainer.string_metrics_interval=0', '--device', 'cpu']
    resumed = str(tmp_path / 'resumed')
    shutil.copytree(run, resumed)
    assert train_cli.main(argv + [f'trainer.default_root_dir={resumed}',
                                  '--resume']) == 0
    assert 'Resumed from step 0' in capsys.readouterr().out
    losses = {}
    with open(os.path.join(resumed, 'metrics.csv')) as f:
        for line in f.read().splitlines()[1:]:
            _, step, metric, value = line.split(',')
            if metric == 'train_loss':
                losses[int(step)] = float(value)
    assert sorted(losses) == [1, 2]
    assert Checkpointer(os.path.join(resumed, 'checkpoints')).latest_step() \
        == 2

    cfg = load_config(argv[:-2])
    labels = build_labels(cfg['model'])
    train_loader, _ = train_cli.get_data_loaders(labels, cfg['data'])
    batch = to_device(train_loader.peek_batch(), torch.device('cpu'))

    def first_loss(state_dict):
        model = build_model(cfg['model'], len(labels))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        opt, sched = build_optimizer(model.parameters(), cfg['model'], 1, 1)
        tr = Trainer(cfg, model, build_frontend(cfg['model']), opt, sched,
                     GreedyDecoder(labels), device='cpu',
                     run_dir=str(tmp_path / 'hand'))
        try:
            return float(tr.train_step(batch)[0])
        finally:
            tr.close()
    imported_sd = Checkpointer(os.path.join(run, 'checkpoints')).restore()
    assert losses[1] == pytest.approx(first_loss(imported_sd['model']),
                                      rel=1e-6)
    assert losses[1] != pytest.approx(first_loss(None), rel=1e-3)


def test_unbuildable_optimizer_falls_back_to_sgd(corpus, tmp_path):
    """An optimizer block the config cannot build (a torch target neither
    package maps): both scripts import with plain SGD at 1e-4."""
    _, _, ckpt = corpus
    bad = OVERRIDES + ['model.optimizer._target_=torch.optim.LBFGS']
    run = str(tmp_path / 'port')
    assert port_imp.main(['--ckpt', ckpt, '--out', run, *bad]) == 0
    opt = Checkpointer(os.path.join(run, 'checkpoints')).restore()['optimizer']
    assert [g['lr'] for g in opt['param_groups']] == [1e-4]
    assert opt['param_groups'][0]['momentum'] == 0
    assert _script('import_torch_checkpoint').main(
        ['--ckpt', ckpt, '--out', str(tmp_path / 'jax'), *bad,
         'trainer.mesh.data=2']) == 0
    with pytest.raises(ValueError, match='Unknown optimizer'):
        build_optimizer([torch.zeros(1, requires_grad=True)],
                        load_config(['data.train_manifest=x',
                                     'data.val_manifest=y', *bad])['model'],
                        1, 1)
