"""Jasper / QuartzNet serving of the port vs the JAX package's, on the CPU.

* Artifacts both ways: ``export_serving_jasper`` writes the JAX format
  (the same arrays and ``serving.json``), a port artifact streams through
  the JAX ``StreamingJasper`` as through the port's, and a JAX artifact
  through the port's as through JAX's.
* The multiplexer and the TCP server over a ``StreamingJasper`` (nested
  state tuples): the JAX multiplexer's transcripts and schedule, the
  dedicated sessions' finals over TCP, the JAX server's error texts.
* The entry points on tiny runs: ``evaluate --streaming`` and
  ``--artifact`` on a JAX QuartzNet-shaped run (exported weights) print
  ``test.py``'s lines, dump and result; ``export_serving`` exports a port
  Jasper run and refuses ``--int8``; ``stream_demo`` streams a run of
  each family.
"""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import _run_stream
from tests.test_streaming_jasper import (JASPER_DENSE, JASPER_SMALL, N_MELS,
                                         _build, _norm_blocks)
from tests.test_torch_stream_server import (LABELS, SLOTS, _dedicated,
                                            _error_texts, _serve, _staggered,
                                            _starved, _streams)
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu_torch import evaluate as port_eval
from wav2letter_pytorch_tpu_torch import export_serving as export_cli
from wav2letter_pytorch_tpu_torch import serve_tcp, serving, stream_demo
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.models.jasper import Jasper
from wav2letter_pytorch_tpu_torch.serving.net import StreamClient
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
STATS = (np.zeros(N_MELS, np.float32), np.ones(N_MELS, np.float32))
AUDIO_CONF = {'sample_rate': SR, 'window_size': 0.02, 'window_stride': 0.01,
              'window': 'hamming'}
# Port stream vs JAX stream, probabilities (tests/test_torch_streaming_
# jasper.py's STREAM_TOL).
STREAM_TOL = 1e-5
# A tiny QuartzNet (C1 and one B block narrowed): the JAX run's model list
# and the same blocks as the port's path overrides.
JAX_BLOCKS = ('model.jasper_blocks=[{layer_size: 16, kernel_size: 7, '
              'stride: 2, residual: false, separable: true}, {layer_size: '
              '16, kernel_size: 5, repeat: 2, residual: true, separable: '
              'true}]')
PORT_BLOCKS = ['model.jasper_blocks.0.layer_size=16',
               'model.jasper_blocks.0.kernel_size=7',
               'model.jasper_blocks.1.layer_size=16',
               'model.jasper_blocks.1.kernel_size=5',
               'model.jasper_blocks.1.repeat=2']
RUN_OVERRIDES = ['model=quartznet', 'model.input_size=32',
                 'model.mid_layers=2', 'data.batch_size=2',
                 'data.num_length_buckets=1']


def _pair(blocks, seed=0):
    """(JAX variables, the port's eval Jasper) on the same weights."""
    _, variables, _ = _build(blocks, seed=seed)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = Jasper(blocks, len(LABELS), input_size=N_MELS,
                   mid_layers=len(blocks))
    model.load_state_dict(state_dict_from_flax(variables, blocks),
                          strict=True)
    return variables, model.eval()


@pytest.fixture(scope='module')
def small():
    """(JAX streamer, the port's streamer on the CPU, JAX variables, the
    port's model) on JASPER_SMALL, chunk 16, fixed statistics."""
    variables, model = _pair(JASPER_SMALL)
    kw = dict(chunk_frames=16, norm='precomputed', norm_stats=STATS)
    jsw = jserve.StreamingJasper(
        JASPER_SMALL, len(LABELS), variables,
        JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0), **kw)
    sw = serving.StreamingJasper(
        JASPER_SMALL, len(LABELS), model,
        SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
        device='cpu', **kw)
    return jsw, sw, variables, model


def _audio(length, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, length)) * 0.1).astype(np.float32)


# ------------------------------------------------------------- artifacts

@pytest.mark.parametrize('case', ['dense_batch_norm', 'group_norm'])
def test_artifacts_stream_the_same_in_both_packages(tmp_path, case):
    """The port's ``export_serving_jasper`` writes the JAX function's
    arrays and metadata; the port's artifact streams through JAX's
    ``streaming_from_artifact`` within STREAM_TOL of the port's, and
    JAX's artifact through the port's within STREAM_TOL of JAX's."""
    if case == 'group_norm':
        from tests.test_torch_streaming_jasper import _norm_pair
        blocks = _norm_blocks('group', 2)
        variables, model = _norm_pair(blocks)
    else:
        blocks = JASPER_DENSE
        variables, model = _pair(blocks, seed=5)
    kw = dict(labels=LABELS, audio_conf=AUDIO_CONF, norm_stats=STATS,
              n_mels=N_MELS)
    port_art = serving.export_serving_jasper(
        str(tmp_path / 'port'), blocks, len(LABELS), model, **kw)
    jax_art = jserve.export_serving_jasper(
        str(tmp_path / 'jax'), blocks, len(LABELS), variables, **kw)
    for name in ('serving.json',):
        with open(os.path.join(port_art, name)) as f, \
                open(os.path.join(jax_art, name)) as g:
            assert json.load(f) == json.load(g)
    got, want = (np.load(os.path.join(a, 'serving.npz'))
                 for a in (port_art, jax_art))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for art in (port_art, jax_art):
        jsw, _, _ = jserve.export.streaming_from_artifact(art,
                                                          chunk_frames=16)
        sw, labels, meta = serving.streaming_from_artifact(
            art, chunk_frames=16, device='cpu')
        assert labels == LABELS and meta['family'] == 'jasper'
        assert isinstance(sw, serving.StreamingJasper) and sw.norm == \
            'precomputed'
        length = sw.prime_samples + 2 * sw.chunk_samples + 901
        audio = _audio(length, 3)
        a, va = _run_stream(sw, audio, np.array([length]))
        b, vb = _run_stream(jsw, audio, np.array([length]))
        assert int(va[0]) == int(vb[0]) > 0
        v = int(va[0])
        np.testing.assert_allclose(a[0, :v], b[0, :v], rtol=0,
                                   atol=STREAM_TOL)


# ------------------------------------------------ multiplexer and server

def test_multiplexer_over_jasper_matches_jax(small):
    """StreamMultiplexer with a StreamingJasper (nested norm statistics
    in its state): staggered attaches and detaches give the JAX
    multiplexer's partials and finals and the dedicated sessions'; a
    starved slot (tick_ready) is left as it was."""
    jsw, sw, _, _ = small
    cs = sw.chunk_samples
    streams = _streams(sw, 21, [5 * cs + 700, 4 * cs + 1300, 3 * cs])
    got, got_partials = _staggered(serving, sw, streams)
    want, want_partials = _staggered(jserve, jsw, streams)
    assert got == [_dedicated(sw, a) for a in streams]
    assert got == want and got_partials == want_partials
    assert any(got)
    fast, slow = _streams(sw, 11, [4 * cs + 100, 2 * cs + 900])
    got = _starved(serving, sw, fast, slow)
    assert got == [_dedicated(sw, fast), _dedicated(sw, slow)]
    assert got == _starved(jserve, jsw, fast, slow)


def test_multiplexer_state_map_keeps_nested_types():
    """The multiplexer's state map over a group-norm Jasper's state: the
    NamedTuple and its tuple of (count, sum, sumsq) triples rebuilt, every
    tensor mapped; and a multiplexed stream's final is its dedicated
    session's."""
    from tests.test_torch_streaming_jasper import _norm_pair
    from wav2letter_pytorch_tpu_torch.serving.server import _map_state
    blocks = _norm_blocks('group', 2)
    _, model = _norm_pair(blocks)
    sw = serving.StreamingJasper(
        blocks, len(LABELS), model,
        SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
        chunk_frames=16, device='cpu')
    state, _ = sw._prime_fn(sw._weights_dev, sw.audio_tensor(
        _audio(sw.prime_samples, 1)))
    tiled = _map_state(lambda t: t.repeat_interleave(3, dim=0), state)
    assert type(tiled) is serving.JasperStreamState
    assert len(tiled.gnorms) == len(state.gnorms) == 4
    for g, s in zip(tiled.gnorms, state.gnorms):
        assert type(g) is tuple and len(g) == 3
        for a, b in zip(g, s):
            torch.testing.assert_close(a, b.repeat_interleave(3, dim=0),
                                       rtol=0, atol=0)
    assert all(c.shape[0] == 3 for c in tiled.conv_carries)
    audio = _audio(sw.prime_samples + 3 * sw.chunk_samples + 500, 2)[0]
    mux = serving.StreamMultiplexer(sw, slots=2, labels=LABELS)
    slot = mux.attach()
    mux.feed(slot, audio[:sw.prime_samples + sw.chunk_samples])
    mux.tick()
    mux.feed(slot, audio[sw.prime_samples + sw.chunk_samples:])
    while mux.pending(slot) >= sw.chunk_samples:
        mux.tick()
    assert mux.detach(slot) == _dedicated(sw, audio)


def test_serve_tcp_serves_a_jasper_artifact(tmp_path, small):
    """``serve_tcp`` on a port Jasper artifact (f32 + CMVN): two
    concurrent clients get their dedicated sessions' finals (equal to the
    JAX streamer's on the same artifact), the ``--client`` mode prints the
    same, and protocol faults get the JAX server's error texts."""
    _, _, _, model = small
    art = serving.export_serving_jasper(
        str(tmp_path / 'art'), JASPER_SMALL, len(LABELS), model,
        labels=LABELS, audio_conf=AUDIO_CONF, norm_stats=STATS,
        n_mels=N_MELS)
    srv, meta = serve_tcp.build_server(serve_tcp.parse_args(
        ['--artifact', art, '--port', '0', '--slots', str(SLOTS),
         '--chunk-frames', '16', '--device', 'cpu']))
    assert meta['family'] == 'jasper' and srv.mux.slots == SLOTS
    sw = srv.mux.m
    jsw, _, _ = jserve.export.streaming_from_artifact(art, chunk_frames=16)
    rng = np.random.default_rng(44)
    streams = [(rng.standard_normal(sw.prime_samples + n) * 0.3)
               .astype(np.float32)
               for n in (3 * sw.chunk_samples + 777, 2 * sw.chunk_samples)]
    expected = [_dedicated(sw, a) for a in streams]
    assert expected == [_dedicated(jsw, a, jserve) for a in streams]
    want_srv = jserve.StreamingServer(jsw, LABELS, slots=SLOTS, poll=0.002)
    stop = _serve(want_srv)
    try:
        want_texts = _error_texts(want_srv.port)
    finally:
        stop()
    stop = _serve(srv)
    finals = [None] * 2
    try:
        def client(i, piece):
            c = StreamClient('127.0.0.1', srv.port, sample_rate=SR)
            for j in range(0, len(streams[i]), piece):
                c.send(streams[i][j:j + piece])
            finals[i] = c.finish()
        threads = [threading.Thread(target=client, args=(i, p))
                   for i, p in enumerate((5000, 1601))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        wav = str(tmp_path / 'a.wav')
        from wav2letter_pytorch_tpu_torch.data.audio_io import (read_wav,
                                                                write_wav)
        write_wav(wav, streams[0], SR)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert serve_tcp.main(['--client', wav, '--port',
                                   str(srv.port)]) == 0
        want_wav = _dedicated(sw, read_wav(wav)[0])
        got_texts = _error_texts(srv.port)
    finally:
        stop()
    assert finals == expected and any(finals)
    assert out.getvalue().strip().splitlines()[-1] == \
        f'final  : {want_wav!r}'
    assert len(want_texts) == 7 and got_texts == want_texts


# ------------------------------------------------------ the entry points

@pytest.fixture(scope='module')
def jax_jasper_run(tmp_path_factory):
    """A tiny JAX QuartzNet-shaped run (2 steps), its weights exported by
    scripts/export_torch_checkpoint.py, a JAX artifact of it with CMVN,
    and a 3-gram LM."""
    import sys

    import train as jax_train
    from tests.test_train_e2e import _make_corpus
    from wav2letter_pytorch_tpu.decoding.ngram_train import train_arpa
    root = tmp_path_factory.mktemp('jax_jasper_run')
    manifest = _make_corpus(root)
    run = root / 'run'
    assert jax_train.main([
        f'data.train_manifest={manifest}', f'data.val_manifest={manifest}',
        *RUN_OVERRIDES, JAX_BLOCKS, 'trainer.max_epochs=1',
        'trainer.max_steps=2', 'trainer.string_metrics_interval=0',
        'trainer.mesh.data=2', f'trainer.default_root_dir={run}']) == 0
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import export_serving as jax_export
        import export_torch_checkpoint
    finally:
        sys.path.remove(os.path.join(REPO, 'scripts'))
    export = str(root / 'export.ckpt')
    assert export_torch_checkpoint.main(['--model-path', str(run), '--out',
                                         export]) == 0
    art = str(root / 'artifact')
    assert jax_export.main(['--model-path', str(run), '--out', art,
                            '--cmvn-manifest', manifest]) == 0
    lm = str(root / 'lm.arpa')
    with open(manifest) as f:
        train_arpa([json.loads(line)['text'] for line in f], lm, order=3)
    return str(run), manifest, export, art, lm


def _print_lines(lines):
    return [line for line in lines if line.startswith(
        ('reference: ', 'decoded  : ', 'timings  : '))]


def _test_py(argv, capsys):
    import test as test_cli
    assert test_cli.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), out[:-1]


def _port_cli(argv, capsys):
    assert port_eval.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), out[:-1]


@pytest.mark.parametrize('mode', [
    ['--streaming-chunk-frames', '8', '--word-timings'],
    ['--streaming-chunk-frames', '8', '--int8', '--streaming-norm', 'cmvn',
     '--streaming-cmvn-manifest', '{manifest}', '--word-timings',
     '--beam-search-params', 'k=4,alpha=0.5,beta=1', '--lm-path', '{lm}'],
    []],
    ids=['greedy', 'int8_cmvn_beam_lm', 'below_prime'])
def test_streaming_cli_prints_what_test_py_prints(tmp_path, jax_jasper_run,
                                                  capsys, mode):
    """test.py --streaming on the JAX QuartzNet run and the port's
    evaluate --streaming on its exported weights: the same pairs, word
    timings, dump records and JSON line. Chunk 8 streams every utterance
    through StreamingJasper (greedy; int8 weights, corpus CMVN, beam + LM
    on its probabilities); the default chunk of 64 puts each below the
    prime window, through the eval forward."""
    run, manifest, export, _, lm = jax_jasper_run
    mode = [a.format(manifest=manifest, lm=lm) for a in mode]
    common = ['--test-manifest', manifest, '--streaming', '--print-all',
              *mode]
    want, want_lines = _test_py(['--model-path', run, *common,
                                 '--dump-jsonl', str(tmp_path / 'j.jsonl')],
                                capsys)
    got, got_lines = _port_cli(
        ['--weights', export, '--device', 'cpu', *common, '--dump-jsonl',
         str(tmp_path / 'p.jsonl'), *RUN_OVERRIDES, *PORT_BLOCKS], capsys)
    assert _print_lines(got_lines) == _print_lines(want_lines)
    assert len(_print_lines(got_lines)) >= 12
    assert (tmp_path / 'p.jsonl').read_text() == \
        (tmp_path / 'j.jsonl').read_text()
    assert got == want and got['num_utterances'] == 6
    assert got['offline_fallback'] == (6 if not mode else 0)


def test_artifact_cli_prints_what_test_py_prints(tmp_path, jax_jasper_run,
                                                 capsys):
    """test.py --artifact and the port's evaluate --artifact on the JAX
    run's Jasper artifact (streaming, its CMVN): the same pairs, dump
    and JSON line; --offline refused as test.py refuses it."""
    _, manifest, _, art, _ = jax_jasper_run
    common = ['--artifact', art, '--test-manifest', manifest, '--print-all',
              '--streaming-chunk-frames', '8']
    want, want_lines = _test_py([*common, '--dump-jsonl',
                                 str(tmp_path / 'j.jsonl')], capsys)
    got, got_lines = _port_cli([*common, '--device', 'cpu', '--dump-jsonl',
                                str(tmp_path / 'p.jsonl')], capsys)
    assert _print_lines(got_lines) == _print_lines(want_lines)
    assert (tmp_path / 'p.jsonl').read_text() == \
        (tmp_path / 'j.jsonl').read_text()
    assert got == want and got['streaming'] and got['num_utterances'] == 6
    with pytest.raises(SystemExit, match='supports wav2letter'):
        port_eval.main([*common, '--offline', '--device', 'cpu'])


@pytest.fixture(scope='module')
def port_runs(tmp_path_factory):
    """Tiny port runs (1 epoch over 6 short utterances): the QuartzNet
    shape of ``jax_jasper_run`` and a one-layer Wav2Letter."""
    from tests.test_train_e2e import _make_corpus
    from wav2letter_pytorch_tpu_torch import train as port_train
    root = tmp_path_factory.mktemp('port_runs')
    manifest = _make_corpus(root)
    runs = {}
    for name, extra in (('jasper', [*RUN_OVERRIDES, *PORT_BLOCKS]),
                        ('wav2letter', ['model.input_size=32',
                                        'model.layers.0.output_size=24',
                                        'model.layers.0.kernel_size=7',
                                        'data.batch_size=2',
                                        'data.num_length_buckets=1'])):
        run = root / name
        assert port_train.main([
            f'data.train_manifest={manifest}',
            f'data.val_manifest={manifest}', *extra,
            'trainer.max_epochs=1', f'trainer.default_root_dir={run}',
            '--device', 'cpu']) == 0
        runs[name] = str(run)
    return runs, manifest


def test_export_cli_exports_a_jasper_run(tmp_path, port_runs, capsys):
    """export_serving --model-path <port Jasper run>: the run's
    fold_jasper in the JAX format with its CMVN; test.py streams the
    port's artifact as the port's evaluate --artifact does; --int8 and
    --calibrate refused as the JAX script refuses them."""
    from wav2letter_pytorch_tpu_torch.training.build import load_run
    runs, manifest = port_runs
    art = str(tmp_path / 'art')
    assert export_cli.main(['--model-path', runs['jasper'], '--out', art,
                            '--cmvn-manifest', manifest, '--device',
                            'cpu']) == 0
    cfg, model, labels, _ = load_run(runs['jasper'])
    blocks = cfg['model']['jasper_blocks'][:2]
    meta, folded, stats = jserve.load_serving(art)
    assert meta['family'] == 'jasper' and meta['format'] == 'f32'
    assert meta['labels'] == labels and meta['n_mels'] == 32
    assert stats is not None
    g_leaves, g_tree = jax.tree_util.tree_flatten(folded)
    w_leaves, w_tree = jax.tree_util.tree_flatten(
        serving.fold_jasper(model, blocks))
    assert g_tree == w_tree
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_array_equal(g, w)
    common = ['--artifact', art, '--test-manifest', manifest, '--print-all',
              '--streaming-chunk-frames', '8']
    want, want_lines = _test_py(common, capsys)
    got, got_lines = _port_cli([*common, '--device', 'cpu'], capsys)
    assert _print_lines(got_lines) == _print_lines(want_lines)
    assert got == want and got['num_utterances'] == 6
    for flag in ('--int8', '--calibrate'):
        with pytest.raises(SystemExit, match='stored f32'):
            export_cli.main(['--model-path', runs['jasper'], '--out',
                             str(tmp_path / 'q'), flag, '--cmvn-manifest',
                             manifest, '--device', 'cpu'])
    assert not (tmp_path / 'q').exists()


@pytest.mark.parametrize('family, flags', [('jasper', []),
                                           ('jasper', ['--int8']),
                                           ('wav2letter', [])])
def test_stream_demo_streams_each_family(port_runs, capsys, family, flags):
    """stream_demo --synthetic on a tiny run of each family: its final
    transcript is a dedicated StreamingTranscriber's over the same
    streamer on the same audio."""
    from wav2letter_pytorch_tpu_torch.training.build import (build_frontend,
                                                             load_run)
    runs, _ = port_runs
    argv = ['--model-path', runs[family], '--synthetic', '1.5',
            '--chunk-frames', '16', '--device', 'cpu', *flags]
    assert stream_demo.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    final = [line for line in out if line.startswith('final')]
    args = stream_demo.parse_args(argv)
    cfg, model, labels, _ = load_run(runs[family])
    sw = stream_demo.build_streamer(
        cfg, model.eval(), build_frontend(cfg['model'], dither=0.0),
        len(labels), 16, bool(flags), 'cpu')
    assert isinstance(sw, serving.StreamingJasper) == (family == 'jasper')
    audio = stream_demo.read_audio(args, SR)
    assert len(audio) == int(1.5 * SR)
    tr = serving.StreamingTranscriber(sw.start(1), labels)
    tr.feed(audio[None])
    want = tr.finish(np.array([len(audio)]))[0]
    assert len(final) == 1 and final[0].endswith(f': {want!r}')
    with pytest.raises(SystemExit, match='--wav or --synthetic'):
        stream_demo.main(['--model-path', runs[family], '--device', 'cpu'])
