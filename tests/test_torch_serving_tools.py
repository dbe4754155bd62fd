"""The port's serving tools vs the JAX package's scripts of the same names:
``train_synthetic_demo`` (its corpus), ``build_arpa``, ``error_analysis``,
``align`` and ``validate_serving`` (parity on a tiny trained port run, the
same-tag WER check, and where it writes). The port runs on the CPU."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import N_MELS, SMALL_LAYERS, _build
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu_torch import align as port_align
from wav2letter_pytorch_tpu_torch import build_arpa as port_arpa
from wav2letter_pytorch_tpu_torch import error_analysis as port_errors
from wav2letter_pytorch_tpu_torch import export_serving as export_cli
from wav2letter_pytorch_tpu_torch import train_synthetic_demo as demo
from wav2letter_pytorch_tpu_torch import validate_serving as validate
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = list('_abcde ')
AUDIO_CONF = {'sample_rate': 16000, 'window_size': 0.02,
              'window_stride': 0.01, 'window': 'hamming'}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_script_{name}', os.path.join(REPO, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_make_corpus_writes_the_jax_corpus(tmp_path):
    """The same WAV bytes and transcripts, split by split."""
    want = _script('train_synthetic_demo').make_corpus(
        str(tmp_path / 'jax'), n_train=4, n_val=2)
    got = demo.make_corpus(str(tmp_path / 'port'), n_train=4, n_val=2)
    assert set(got) == set(want) == {'train', 'val'}
    for split in ('train', 'val'):
        with open(want[split]) as f:
            want_rows = [json.loads(line) for line in f]
        with open(got[split]) as f:
            got_rows = [json.loads(line) for line in f]
        assert len(got_rows) == len(want_rows) == (4 if split == 'train'
                                                   else 2)
        for g, w in zip(got_rows, want_rows):
            assert g['text'] == w['text']
            assert os.path.basename(g['audio_filepath']) == \
                os.path.basename(w['audio_filepath'])
            with open(g['audio_filepath'], 'rb') as a, \
                    open(w['audio_filepath'], 'rb') as b:
                assert a.read() == b.read()


def test_train_overrides_are_the_jax_scripts(tmp_path):
    """The demo trains the JAX script's model: its overrides, as the
    port's config composes them."""
    from wav2letter_pytorch_tpu_torch.config import load_config
    cfg = load_config(demo.train_overrides(
        {'train': 't.jsonl', 'val': 'v.jsonl'}, str(tmp_path), 12))
    assert [(l['output_size'], l['kernel_size'], l['stride'])
            for l in cfg['model']['layers']] == [(128, 11, 2), (128, 11, 1),
                                                 (256, 13, 1)]
    assert cfg['model']['mid_layers'] == 3
    assert cfg['data']['batch_size'] == 16
    assert cfg['model']['optimizer']['lr'] == 2e-3
    aug = load_config(demo.train_overrides(
        {'train': 't', 'val': 'v'}, str(tmp_path), 1, augment=True))
    assert aug['data']['augment'] == {'spec_augment': {
        'freq_masks': 2, 'time_masks': 2, 'freq_width': 8,
        'time_width': 12}}


@pytest.mark.parametrize('source', ['text', 'csv', 'jsonl'])
def test_build_arpa_writes_the_jax_file(tmp_path, source):
    """The same ARPA file and the same JSON line (but its path)."""
    texts = ['the cat sat', 'the cat ran', 'a dog sat', 'the dog ran away',
             'a cat', 'dog']
    if source == 'text':
        path = tmp_path / 'corpus.txt'
        path.write_text('\n'.join(texts + ['']))
        flag = '--text'
    elif source == 'csv':
        from wav2letter_pytorch_tpu_torch.data.prepare_librispeech import \
            write_csv_manifest
        path = tmp_path / 'train.csv'
        write_csv_manifest([(f'u{i}.wav', t) for i, t in enumerate(texts)],
                           str(path))
        flag = '--manifest'
    else:
        path = tmp_path / 'train.jsonl'
        path.write_text('\n'.join(json.dumps({'audio_filepath': f'u{i}.wav',
                                              'text': t})
                                  for i, t in enumerate(texts)))
        flag = '--manifest'
    lines = {}
    for name, main in (('jax', _script('build_arpa').main),
                       ('port', port_arpa.main)):
        rc, out = _run(main, [flag, str(path), '--out',
                              str(tmp_path / f'{name}.arpa'), '--order', '3'])
        assert rc == 0
        lines[name] = json.loads(out.strip().splitlines()[-1])
        lines[name].pop('out')
    assert lines['port'] == lines['jax']
    assert lines['port']['sentences'] == len(texts)
    assert (tmp_path / 'port.arpa').read_bytes() == \
        (tmp_path / 'jax.arpa').read_bytes()


def test_error_analysis_prints_the_jax_report(tmp_path):
    rows = [('a/u0.wav', 'the cat sat', 'the cat sat'),
            ('a/u1.wav', 'the dog ran away', 'a dog ran'),
            ('a/u2.wav', 'a cat', 'the the cat'),
            ('a/u3.wav', 'the dog', 'a dog'),
            ('a/u4.wav', 'dog', '')]
    # Edit counts as evaluate --dump-jsonl writes them.
    from wav2letter_pytorch_tpu_torch.decoding.levenshtein import align
    recs = [{'path': path, 'ref': ref, 'hyp': hyp,
             'wer_edits': sum(op != 'ok' for op, _, _ in align(
                 ref.split(), hyp.split())),
             'ref_words': len(ref.split())} for path, ref, hyp in rows]
    dump = tmp_path / 'utts.jsonl'
    dump.write_text(''.join(json.dumps(r) + '\n' for r in recs))
    outs, reports = {}, {}
    for name, main in (('jax', _script('error_analysis').main),
                       ('port', port_errors.main)):
        report = tmp_path / f'{name}.json'
        rc, outs[name] = _run(main, [str(dump), '--worst', '3', '--top', '4',
                                     '--json-out', str(report)])
        assert rc == 0
        reports[name] = json.loads(report.read_text())
    assert outs['port'] == outs['jax']
    assert reports['port'] == reports['jax']
    edits = sum(r['wer_edits'] for r in recs)
    words = sum(r['ref_words'] for r in recs)
    assert reports['port']['wer'] == edits / words


@pytest.fixture(scope='module')
def jax_artifact(tmp_path_factory):
    """A JAX artifact of the small Wav2Letter (f32, with CMVN) and a WAV
    manifest of transcripts over its labels."""
    root = tmp_path_factory.mktemp('align')
    _, variables, _ = _build(SMALL_LAYERS)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    rng = np.random.default_rng(5)
    stats = (rng.standard_normal(N_MELS).astype(np.float32),
             rng.uniform(0.5, 2, N_MELS).astype(np.float32))
    art = jserve.export_serving(str(root / 'art'), SMALL_LAYERS, 7,
                                variables, labels=LABELS,
                                audio_conf=AUDIO_CONF, norm_stats=stats)
    texts = ['abc', 'bad cab', 'ace', 'dab bed', 'cab', 'a b c d e',
             'bead', 'dace', 'ed', 'abba cade']
    rows = []
    for i, text in enumerate(texts):
        n = 12000 + 1600 * i
        audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
        path = str(root / f'u{i}.wav')
        write_wav(path, audio, 16000)
        rows.append({'audio_filepath': path, 'text': text})
    manifest = root / 'align.jsonl'
    manifest.write_text('\n'.join(json.dumps(r) for r in rows))
    return art, str(manifest)


@pytest.mark.parametrize('norm', ['per-utterance', 'cmvn'])
def test_align_gives_the_jax_words_and_timings(tmp_path, jax_artifact,
                                               norm):
    art, manifest = jax_artifact
    lines, records = {}, {}
    for name, main, flag in (('jax', _script('align').main, '--cpu'),
                             ('port', port_align.main, '--device=cpu')):
        out = tmp_path / f'{name}.jsonl'
        rc, text = _run(main, ['--artifact', art, '--manifest', manifest,
                               '--out', str(out), '--norm', norm, flag])
        assert rc == 0
        lines[name] = json.loads(text.strip().splitlines()[-1])
        lines[name].pop('out')
        records[name] = [json.loads(line)
                         for line in out.read_text().splitlines()]
    assert lines['port'] == lines['jax']
    assert lines['port'] == {'num_utterances': 10, 'failed': 0,
                             'frame_seconds': 0.02}
    assert records['port'] == records['jax']
    assert all(len(r['words']) == len(r['text'].split())
               for r in records['port'])


@pytest.fixture(scope='module')
def demo_run(tmp_path_factory):
    """train_synthetic_demo for one epoch over 8 utterances (val cut to 4
    for time) on the CPU, and its f32 artifact with corpus CMVN."""
    root = str(tmp_path_factory.mktemp('demo'))
    make_corpus = demo.make_corpus
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(demo, 'make_corpus', lambda r, n_train=400:
                   make_corpus(r, n_train=n_train, n_val=4))
        rc, out = _run(demo.main, ['--epochs', '1', '--n-train', '8',
                                   '--out', root, '--device', 'cpu'])
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert set(result) == {'demo', 'train_wer', 'train_cer', 'val_wer',
                           'val_cer'}
    art = os.path.join(root, 'artifact_f32')
    assert export_cli.main(['--model-path', os.path.join(root, 'run'),
                            '--out', art, '--cmvn-manifest',
                            os.path.join(root, 'data', 'train.jsonl'),
                            '--device', 'cpu']) == 0
    return root, art


def test_run_parity_holds_on_a_trained_run(demo_run):
    root, art = demo_run
    result, ok = validate.run_parity(
        os.path.join(root, 'run'), art,
        os.path.join(root, 'data', 'val.jsonl'), device='cpu')
    assert ok and result['utterances'] == 4
    for name, tol in validate.PARITY_TOL.items():
        assert result[name]['tolerance'] == tol
        assert result[name]['max_abs_delta'] <= tol
        assert result[name]['ok']
    # The artifact's npz round trip is exact.
    assert result['folded_vs_artifact']['max_abs_delta'] == 0.0


def test_same_tag_checks():
    """Pairs under one tag compare; a pair over other streaming coverage
    does not; a gap above SAME_TAG_WER_TOL fails; the JAX tolerances."""
    assert validate.SAME_TAG_WER_TOL == _script(
        'validate_serving').SAME_TAG_WER_TOL == 0.01
    assert validate.PARITY_TOL == _script('validate_serving').PARITY_TOL
    results = {'a': {'wer': 0.5}, 'b': {'wer': 0.505},
               'c': {'wer': 0.2, 'skipped_below_prime': 3},
               'd': {'wer': 0.7}}
    tags = {'x': ['a', 'b', 'c'], 'y': ['d']}
    checks, ok = validate.same_tag_checks(results, tags)
    assert ok and checks == [{'pair': ['a', 'b'], 'tag': 'x',
                              'wer_delta': 0.005, 'ok': True}]
    results['b']['wer'] = 0.52
    checks, ok = validate.same_tag_checks(results, tags)
    assert not ok and checks[0]['ok'] is False


def test_validate_serving_writes_its_report_and_nothing_in_benchmarks(
        demo_run, tmp_path, monkeypatch):
    root, _ = demo_run
    bench = os.path.join(REPO, 'benchmarks')

    def files():    # other tests' imports may write bytecode there
        return {n: os.stat(os.path.join(bench, n)).st_mtime_ns
                for n in os.listdir(bench) if n != '__pycache__'}
    before = files()
    make_corpus = demo.make_corpus
    monkeypatch.setattr(demo, 'make_corpus', lambda r, n_train=400:
                        make_corpus(r, n_train=n_train, n_val=4))
    json_out = str(tmp_path / 'report.json')
    rc, out = _run(validate.main, ['--epochs', '1', '--n-train', '8',
                                   '--out', root, '--json-out', json_out,
                                   '--device', 'cpu'])
    report = json.loads(out.strip().splitlines()[-1])
    with open(json_out) as f:
        assert json.load(f) == report
    assert rc == 0 and report['ok'], report
    assert set(report['paths']) == set(validate.wer_paths('r', 'f', 'i',
                                                          'v'))
    assert report['parity']['utterances'] == 4
    assert files() == before
    assert not os.path.exists(os.path.join(root, 'serving_validation.json'))
