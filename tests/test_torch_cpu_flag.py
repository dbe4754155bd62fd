"""``--cpu`` on the port's entry points, as the JAX package's scripts take
it: ``train``, ``evaluate``, ``export_serving`` and ``align`` run with
``--cpu`` as they do with ``--device cpu``, and each takes its JAX
script's flag set (``train.py``, ``test.py``,
``scripts/export_serving.py``, ``scripts/align.py``) as it is.
"""

import json
import os

import pytest
import torch

from tests.test_train_e2e import _make_corpus
from wav2letter_pytorch_tpu_torch import align as port_align
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import export_serving as port_export
from wav2letter_pytorch_tpu_torch import train as train_cli
from wav2letter_pytorch_tpu_torch.training.checkpoint import Checkpointer

torch.set_num_threads(1)

MODEL = ['model.input_size=32', 'model.layers.0.output_size=24',
         'model.layers.0.kernel_size=7', 'data.batch_size=2',
         'data.num_length_buckets=1']


def _train(manifest, run, device_flags):
    return train_cli.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        *MODEL, 'trainer.max_epochs=1', 'trainer.log_every_n_steps=1',
        f'trainer.default_root_dir={run}', *device_flags])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The same run trained with --cpu and with --device cpu."""
    root = tmp_path_factory.mktemp('cpu_flag')
    manifest = _make_corpus(root)
    out = {}
    for name, flags in (('cpu', ['--cpu']), ('device', ['--device', 'cpu'])):
        run = str(root / name)
        assert _train(manifest, run, flags) == 0
        out[name] = run
    return root, manifest, out


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_train_takes_cpu(runs):
    """train.py's flags (--cpu, --resume): the --cpu run is the --device
    cpu run, metric for metric and weight for weight."""
    _, manifest, out = runs
    rows = {}
    for name, run in out.items():
        with open(os.path.join(run, 'metrics.csv')) as f:
            rows[name] = [line.split(',')[1:] for line in f.read()
                          .splitlines()[1:] if 'per_sec' not in line]
    assert rows['cpu'] == rows['device'] and rows['cpu']
    a, b = (Checkpointer(os.path.join(r, 'checkpoints')).restore()
            for r in (out['cpu'], out['device']))
    assert a['step'] == b['step'] == 3
    for k, v in b['model'].items():
        torch.testing.assert_close(a['model'][k], v, rtol=0, atol=0)
    assert train_cli.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        *MODEL, 'trainer.max_epochs=2',
        f'trainer.default_root_dir={out["cpu"]}', '--resume', '--cpu']) == 0


def test_evaluate_takes_cpu(runs, capsys):
    """test.py's flag set with --cpu prints what --device cpu prints."""
    _, manifest, out = runs
    common = ['--model-path', out['cpu'], '--test-manifest', manifest,
              '--batch-size', '2', '--print-samples', '--average-last', '1']
    assert port_eval.main(common + ['--cpu']) == 0
    got = _lines(capsys)
    assert port_eval.main(common + ['--device', 'cpu']) == 0
    assert got == _lines(capsys)
    assert set(json.loads(got[-1])) == {'loss', 'num_utterances', 'cer',
                                        'wer'}


def test_export_serving_and_align_take_cpu(runs, capsys):
    """scripts/export_serving.py's flag set (--int8 --cmvn-manifest
    --calibrate --cpu) writes the artifact --device cpu writes;
    scripts/align.py's (--artifact --manifest --out --norm --cpu) aligns as
    --device cpu does."""
    root, manifest, out = runs
    arts = {}
    for name, flags in (('cpu', ['--cpu']), ('device', ['--device', 'cpu'])):
        art = str(root / f'art_{name}')
        assert port_export.main(['--model-path', out['cpu'], '--out', art,
                                 '--int8', '--cmvn-manifest', manifest,
                                 '--calibrate', *flags]) == 0
        arts[name] = art
    capsys.readouterr()
    for name in ('serving.json', 'serving.npz'):
        with open(os.path.join(arts['cpu'], name), 'rb') as a, \
                open(os.path.join(arts['device'], name), 'rb') as b:
            assert a.read() == b.read(), name
    records = {}
    for name, flags in (('cpu', ['--cpu']), ('device', ['--device=cpu'])):
        words = str(root / f'words_{name}.jsonl')
        port_align.main(['--artifact', arts['cpu'], '--manifest', manifest,
                         '--out', words, '--norm', 'cmvn', *flags])
        line = json.loads(_lines(capsys)[-1])
        line.pop('out')
        with open(words) as f:
            records[name] = (line, f.read())
    assert records['cpu'] == records['device']
    assert records['cpu'][0]['num_utterances'] == 6
