"""The port's training path end to end on a tiny WAV corpus, on the CPU:
``python -m wav2letter_pytorch_tpu_torch.train`` (config -> loaders ->
train step -> metrics -> checkpoints), resume and preemption, the
checkpointer's retention and averaging, and the config's refusals.

The scenarios are those of the JAX package's ``tests/test_train_e2e.py``
and ``tests/test_checkpoint.py``; the model is the config's default
single-block Wav2Letter (``model.mid_layers=1``).
"""

import json
import math
import os
import signal

import numpy as np
import pytest
import torch

from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.config import load_config
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.decoding.decoder import GreedyDecoder
from wav2letter_pytorch_tpu_torch.optim import constant_lr
from wav2letter_pytorch_tpu_torch.training import trainer as trainer_mod
from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                         build_labels,
                                                         build_model)
from wav2letter_pytorch_tpu_torch.training.checkpoint import (
    Checkpointer, average_checkpoints)
from wav2letter_pytorch_tpu_torch.training.logging import MetricLogger

torch.set_num_threads(1)

SR = 16000
TEXTS = ['abba', 'cab', 'dad at bat', 'a cat sat', 'bad cab', 'tact']


def _make_corpus(root, n=6, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = np.arange(int((0.3 + 0.1 * (i % 3)) * SR)) / SR
        audio = (0.3 * np.sin(2 * np.pi * (250 + 60 * i) * t)
                 + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        path = root / f'utt{i}.wav'
        write_wav(str(path), audio, SR)
        rows.append({'audio_filepath': str(path), 'text': TEXTS[i % 6]})
    manifest = root / 'train.jsonl'
    manifest.write_text('\n'.join(json.dumps(r) for r in rows))
    return str(manifest)


def _base(manifest, run_dir, *extra):
    return [f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', 'data.batch_size=2',
            'data.num_length_buckets=1', f'trainer.default_root_dir={run_dir}',
            '--device', 'cpu', *extra]


def _metric(run_dir, name):
    out = {}
    for line in (run_dir / 'metrics.csv').read_text().splitlines()[1:]:
        _, step, metric, value = line.split(',')
        if metric == name:
            out[int(step)] = value          # bit-exact string compare
    return out


def test_cli_trains_logs_and_checkpoints(tmp_path, capsys):
    manifest = _make_corpus(tmp_path)
    run_dir = tmp_path / 'run'
    assert train_cli.main(_base(manifest, run_dir, 'trainer.max_epochs=2',
                                'trainer.log_every_n_steps=1')) == 0
    metrics = (run_dir / 'metrics.csv').read_text()
    assert metrics.splitlines()[0] == 'time,step,metric,value'
    for name in ('train_loss', 'learning_rate', 'utterances_per_sec',
                 'train_wer', 'train_cer', 'val_loss', 'val_wer'):
        assert name in metrics
    ck = Checkpointer(run_dir / 'checkpoints')
    assert ck.all_steps() == [3, 6]        # 3 batches/epoch, 2 epochs
    assert ck.load_extra() == {'epoch': 2}
    assert all(math.isfinite(float(v))
               for v in _metric(run_dir, 'train_loss').values())
    # ExponentialLR steps once per epoch of 3 updates
    lrs = {s: float(v) for s, v in _metric(run_dir, 'learning_rate').items()}
    assert lrs[3] == 1e-5 and lrs[4] == pytest.approx(1e-5 * 0.999)
    assert json.loads((run_dir / 'config.json').read_text())['data'][
        'batch_size'] == 2
    capsys.readouterr()
    assert train_cli.main(['data.train_manifest=x', 'data.val_manifest=y',
                           'optimizer=novograd', '--cfg']) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg['data']['train_manifest'] == 'x'
    assert cfg['model']['optimizer']['_target_'] == 'novograd.Novograd'
    assert cfg['data']['audio_conf'] == cfg['model']['audio_conf']


def test_loss_decreases_when_overfitting(tmp_path):
    """The default single-block model on one repeated batch, AdamW 3e-3."""
    manifest = _make_corpus(tmp_path, n=2, seed=1)
    cfg = load_config(_base(manifest, tmp_path / 'run')[:-2])
    cfg['model']['layers'][0]['dropout'] = -1.0
    labels = build_labels(cfg['model'])
    model = build_model(cfg['model'], len(labels))
    tr = trainer_mod.Trainer(cfg, model, build_frontend(cfg['model']),
                             torch.optim.AdamW(model.parameters(), lr=3e-3,
                                               weight_decay=0.0),
                             constant_lr(3e-3), GreedyDecoder(labels),
                             device='cpu', run_dir=str(tmp_path / 'run'))
    loader, _ = train_cli.get_data_loaders(labels, cfg['data'])
    batch = trainer_mod.to_device(loader.peek_batch(), torch.device('cpu'))
    losses = [float(tr.train_step(batch)[0]) for _ in range(25)]
    assert losses[-1] < 0.7 * losses[0], losses


def test_same_seed_same_loss_trajectory(tmp_path):
    """Shuffle, dither, augmentation and dropout are all keyed on (seed,
    step): two runs log bit-identical losses; another seed does not."""
    manifest = _make_corpus(tmp_path, n=4, seed=3)

    def run(tag, seed):
        run_dir = tmp_path / tag
        assert train_cli.main(_base(
            manifest, run_dir, 'trainer.max_epochs=2', 'trainer.max_steps=3',
            'trainer.log_every_n_steps=1', f'trainer.seed={seed}',
            'trainer.string_metrics_interval=0',
            '+data.augment.spec_augment.time_width=5')) == 0
        return _metric(run_dir, 'train_loss')
    first, second = run('a', 7), run('b', 7)
    assert len(first) == 3 and first == second
    assert run('c', 8) != first


def test_resume_respects_epoch_budget(tmp_path):
    manifest = _make_corpus(tmp_path, n=2, seed=4)
    run_dir = tmp_path / 'resume'
    base = _base(manifest, run_dir, 'trainer.string_metrics_interval=0')
    assert train_cli.main(base + ['trainer.max_epochs=2']) == 0
    assert Checkpointer(run_dir / 'checkpoints').latest_step() == 2
    # the same budget: nothing left to train
    assert train_cli.main(base + ['trainer.max_epochs=2', '--resume']) == 0
    assert Checkpointer(run_dir / 'checkpoints').latest_step() == 2
    # one more epoch: exactly one more step
    assert train_cli.main(base + ['trainer.max_epochs=3', '--resume']) == 0
    ck = Checkpointer(run_dir / 'checkpoints')
    assert ck.latest_step() == 3 and ck.load_extra() == {'epoch': 3}


def test_sigterm_then_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """SIGTERM after the 4th step (mid-epoch 1) saves a resumable
    checkpoint; --resume skips the applied batches and ends with the same
    parameters, BatchNorm statistics and losses as an uninterrupted run."""
    manifest = _make_corpus(tmp_path, n=6, seed=6)

    def base(run_dir):
        return _base(manifest, run_dir, 'trainer.max_epochs=3',
                     'trainer.seed=5', 'trainer.log_every_n_steps=1',
                     'trainer.string_metrics_interval=0',
                     'trainer.checkpoint.every_n_epochs=3')
    ref_dir, pre_dir = tmp_path / 'ref', tmp_path / 'pre'
    assert train_cli.main(base(ref_dir)) == 0

    fired = []
    orig_log = MetricLogger.log

    def log_then_preempt(self, step, metrics):
        orig_log(self, step, metrics)
        if 'train_loss' in metrics and step == 4:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)
    with monkeypatch.context() as mp:
        mp.setattr(MetricLogger, 'log', log_then_preempt)
        assert train_cli.main(base(pre_dir)) == 0
    assert fired == [4]
    ck = Checkpointer(pre_dir / 'checkpoints')
    assert ck.latest_step() == 4
    assert ck.load_extra() == {'epoch': 1, 'epoch_step': 1, 'preempted': True}
    assert train_cli.main(base(pre_dir) + ['--resume']) == 0

    ref = Checkpointer(ref_dir / 'checkpoints').restore()
    pre = Checkpointer(pre_dir / 'checkpoints').restore()
    assert ref['step'] == pre['step'] == 9
    for key, value in ref['model'].items():
        assert torch.equal(value, pre['model'][key]), key
    assert _metric(ref_dir, 'train_loss') == _metric(pre_dir, 'train_loss')


def test_non_finite_loss_raises(tmp_path, monkeypatch):
    manifest = _make_corpus(tmp_path, n=2)
    real = trainer_mod.masked_ctc_mean
    monkeypatch.setattr(trainer_mod, 'masked_ctc_mean',
                        lambda *a: real(*a) * float('nan'))
    with pytest.raises(FloatingPointError, match='non-finite training loss'):
        train_cli.main(_base(manifest, tmp_path / 'nan',
                             'trainer.log_every_n_steps=1'))


def _state(value: float) -> dict:
    return {'step': 0, 'model': {'w': torch.full((2,), float(value)),
                                 'n': torch.tensor(int(value))}}


def test_checkpointer_keep_last_k_and_meta_pruning(tmp_path):
    ck = Checkpointer(tmp_path / 'ck', keep_last=2)
    for step in (1, 2, 3):
        ck.save(step, _state(step), extra={'epoch': step})
    assert ck.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / 'ck')) == [
        'ckpt_2.pt', 'ckpt_3.pt', 'meta_2.json', 'meta_3.json']
    assert ck.load_extra() == {'epoch': 3} and ck.load_extra(1) == {}
    assert float(ck.restore(2)['model']['w'][0]) == 2.0


def test_checkpointer_best_k_never_ranks_saves_without_the_metric(tmp_path):
    ck = Checkpointer(tmp_path / 'ck', keep_last=2, monitor='val_loss')
    ck.save(1, _state(1), metrics={'val_loss': 0.5})
    ck.save(2, _state(2), metrics={'val_loss': 0.9})
    ck.save(3, _state(3))                         # no metric: never ranked
    ck.save(4, _state(4), metrics={'val_loss': 0.7})
    ck.save(5, _state(5), metrics={'val_loss': 0.2})
    assert ck.all_steps() == [1, 3, 5] and ck.latest_step() == 5
    mx = Checkpointer(tmp_path / 'mx', keep_last=1, monitor='acc',
                      mode='max')
    for step, acc in ((1, 0.2), (2, 0.9), (3, 0.5)):
        mx.save(step, _state(step), metrics={'acc': acc})
    assert mx.all_steps() == [2]


def test_average_checkpoints(tmp_path):
    ck = Checkpointer(tmp_path / 'ck', keep_last=5)
    for step in (1, 2, 3, 4):
        ck.save(step, dict(_state(step), step=step))
    avg = average_checkpoints(ck, 3)
    assert torch.allclose(avg['model']['w'], torch.full((2,), 3.0))
    assert int(avg['model']['n']) == 4 and avg['step'] == 4


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    manifest = _make_corpus(tmp_path, n=2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cli.main(_base(manifest, tmp_path / 'r')[:-2])


@pytest.mark.parametrize('override,match', [
    ('trainer.steps_per_dispatch=2', 'steps_per_dispatch'),
    ('trainer.device_cache=true', 'device_cache'),
    ('trainer.mesh.data=2', 'mesh.data'),
    ('model.compute_dtype=bf16', 'compute_dtype'),
    ('model.padding_mode=zeros', 'padding_mode'),
    ('model=jasper', 'not ported'),
    ('model.layers=[{output_size: 8}]', 'list and map'),
    ('trainer.no_such_key=1', 'does not exist'),
])
def test_config_refuses_what_the_port_does_not_do(override, match):
    with pytest.raises((ValueError, KeyError), match=match):
        load_config(['data.train_manifest=x', 'data.val_manifest=y',
                     override])


def test_config_overrides():
    cfg = load_config(['data.train_manifest=x', 'data.val_manifest=y',
                       'model.layers.0.output_size=24', 'optimizer=one_cycle',
                       '+trainer.checkpoint.monitor=val_loss',
                       'trainer.max_steps=7', 'trainer.preempt_signal=null'])
    assert cfg['model']['layers'][0]['output_size'] == 24
    assert cfg['model']['scheduler']['max_lr'] == 1e-3
    assert cfg['trainer']['checkpoint'] == {'every_n_epochs': 1,
                                            'keep_last': 3,
                                            'monitor': 'val_loss'}
    assert cfg['trainer']['max_steps'] == 7
    assert cfg['trainer']['preempt_signal'] is None
    with pytest.raises(ValueError, match='Missing mandatory'):
        load_config([])
