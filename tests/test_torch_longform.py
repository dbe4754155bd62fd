"""Exact long-form inference (``serving/longform.py``) and the
``transcribe_long`` CLI: the port's chunked windows against its own
one-shot forward, and against the JAX package's long-form functions."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import (FLAGSHIP_STRUCTURE, N_MELS, SMALL_LAYERS,
                                  _build)
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data.audio_io import read_audio as jax_read_audio
from wav2letter_pytorch_tpu.data.flac import write_flac_file
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu.decoding.decoder import \
    PrefixBeamSearchLMDecoder as JaxBeam
from wav2letter_pytorch_tpu.serving import longform as jlong
from wav2letter_pytorch_tpu_torch import parallel, serving
from wav2letter_pytorch_tpu_torch import transcribe_long as long_cli
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.data.label_sets import resolve_labels
from wav2letter_pytorch_tpu_torch.decoding.decoder import (
    GreedyDecoder, PrefixBeamSearchLMDecoder)
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.serving import longform

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = list('_abcde ')
AUDIO_CONF = {'sample_rate': 16000, 'window_size': 0.02,
              'window_stride': 0.01, 'window': 'hamming'}
# The port vs JAX: float32 convs and frontends in other summation orders.
LOGP_TOL = 1e-4
# Chunked vs one-shot on the CPU: the same math, but the CPU's conv may sum
# a window's outputs in another order than the whole utterance's (~5e-7
# seen); JAX's test_longform_exact_f32 holds its own at 2e-5.
EXACT_TOL = 2e-5


@pytest.fixture(scope='module')
def small():
    _, variables, _ = _build(SMALL_LAYERS)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    return jserve.fold_batchnorm(variables, len(SMALL_LAYERS))


def _fe(**kw):
    return SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0,
                               **kw)


def _audio(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


def _one_shot(layers, folded, audio, q8_scales=None):
    fe = _fe()
    with torch.no_grad():
        feats, flens = fe(torch.from_numpy(audio[None]),
                          torch.tensor([len(audio)]))
        feats = feats[:, :int(flens[0])]
        if q8_scales is None:
            logp, _ = serving.offline_forward(layers, folded, feats)
        else:
            logp, _ = serving.offline_forward_q8(layers, folded, feats,
                                                 act_scales=q8_scales)
    return logp[0].numpy()


@pytest.mark.parametrize('layers', [SMALL_LAYERS, FLAGSHIP_STRUCTURE],
                         ids=['small', 'flagship'])
def test_plan_windows_equals_jax(layers):
    assert longform.stack_geometry(layers) == jlong.stack_geometry(layers)
    for t in (57, 731, 732, 733, 1024, 5001, 30000):
        for chunk in (1, 40, 120, 2000):
            plan = longform.plan_windows(t, layers, chunk)
            assert plan == jlong.plan_windows(t, layers, chunk)
            w, out_w, starts, keeps = plan
            if w is None:
                continue
            S = longform.stack_geometry(layers)[0]
            assert (t - w) % S == 0
            covered = 0
            for a, (j0, j1, g0) in zip(starts, keeps):
                assert a % S == 0 and 0 <= a <= t - w
                assert 0 <= j0 < j1 <= out_w and g0 == covered
                covered += j1 - j0
            assert covered == longform._out_frames(t, layers)
    with pytest.raises(ValueError, match='chunk_frames'):
        longform.plan_windows(100, layers, 0)


@pytest.mark.parametrize('n_samples', [59957, 60000, 60161])
def test_longform_exact_vs_one_shot(small, n_samples):
    """Odd and even lengths take both SAME-pad parity branches."""
    audio = _audio(n_samples)
    want = _one_shot(SMALL_LAYERS, small, audio)
    got, valid = serving.longform_logprobs(SMALL_LAYERS, small, _fe(), audio,
                                           chunk_frames=40, max_batch=3)
    np.testing.assert_allclose(got, want, atol=EXACT_TOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert valid == (1 + n_samples // 160) // 2


def test_longform_flagship_structure_and_int8(small):
    """The flagship's geometry (stride-2 entry, dilated tail) at toy width,
    and int8_full with static scales on the small stack."""
    gen = torch.Generator().manual_seed(3)
    model = Wav2Letter(7, input_size=N_MELS, layers=FLAGSHIP_STRUCTURE,
                       mid_layers=len(FLAGSHIP_STRUCTURE), generator=gen)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(1.0, 1.5, generator=gen)
    flag = serving.fold_batchnorm(model)
    audio = _audio(160157, seed=11)
    got, _ = serving.longform_logprobs(FLAGSHIP_STRUCTURE, flag, _fe(),
                                       audio, chunk_frames=120, max_batch=4)
    np.testing.assert_allclose(
        got, _one_shot(FLAGSHIP_STRUCTURE, flag, audio), atol=EXACT_TOL,
        rtol=0)

    rng = np.random.default_rng(7)
    scales = serving.calibrate_activation_scales(
        SMALL_LAYERS, small, _fe(),
        (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32),
        np.array([24000, 20000]))
    q = serving.quantize_folded(small)
    audio = _audio(60000, seed=5)
    got, _ = serving.longform_logprobs(SMALL_LAYERS, q, _fe(), audio,
                                       mode='int8_full', act_scales=scales,
                                       chunk_frames=40, max_batch=4)
    # static scales: integer sums and elementwise float32 steps, exact
    np.testing.assert_array_equal(
        got, _one_shot(SMALL_LAYERS, q, audio, q8_scales=scales))


@pytest.mark.parametrize('mode', ['f32', 'int8'])
def test_longform_matches_jax(small, mode):
    folded = small if mode == 'f32' else serving.quantize_folded(small)
    audio = _audio(60161, seed=13)
    want, want_valid = jserve.longform_logprobs(
        SMALL_LAYERS, folded,
        JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0,
                    stft_method='conv'), audio, mode=mode, chunk_frames=40,
        max_batch=4)
    got, valid = serving.longform_logprobs(SMALL_LAYERS, folded, _fe(),
                                           audio, mode=mode, chunk_frames=40,
                                           max_batch=4)
    assert valid == want_valid
    np.testing.assert_allclose(got, want, atol=LOGP_TOL, rtol=0)


def test_single_shot_transcriber_and_refusals(small):
    audio = _audio(8000)
    got, _ = serving.longform_logprobs(SMALL_LAYERS, small, _fe(), audio,
                                       chunk_frames=10_000)
    np.testing.assert_allclose(got, _one_shot(SMALL_LAYERS, small, audio),
                               atol=EXACT_TOL, rtol=0)

    decoder = GreedyDecoder(LABELS)
    audio = _audio(60000, seed=9)
    ref = _one_shot(SMALL_LAYERS, small, audio)
    want = decoder.decode(ref[None], sizes=np.array([ref.shape[0]]))[0]
    lf = serving.LongFormTranscriber(SMALL_LAYERS, small, _fe(), decoder,
                                     chunk_frames=40, max_batch=3,
                                     device='cpu')
    assert lf.transcribe(audio) == want
    # over a CPU mesh of 2 entries the windows split, the result stays
    mesh = parallel.make_mesh(2, device='cpu')
    assert serving.LongFormTranscriber(
        SMALL_LAYERS, small, _fe(), decoder, chunk_frames=40, max_batch=3,
        mesh=mesh).transcribe(audio) == want
    np.testing.assert_allclose(serving.longform_logprobs(
        SMALL_LAYERS, small, _fe(), audio, chunk_frames=40, mesh=mesh)[0],
        ref, atol=EXACT_TOL, rtol=0)
    with pytest.raises(ValueError, match='int8_full'):
        longform.make_window_forward(SMALL_LAYERS, small, mode='int8_full')


def test_blank_segments_and_decode_segmented_match_jax():
    rng = np.random.default_rng(0)
    V = 5
    T = 5000
    lp = np.full((T, V), -10.0, np.float32)
    lp[:, 2] = 0.0
    for t in range(0, T, 97):
        lp[t:t + int(rng.integers(1, 40)), 0] = 10.0
    for kw in ({}, {'min_blank_run': 5}, {'max_frames': 300}):
        segs = longform.blank_segments(lp, **kw)
        assert segs == jlong.blank_segments(lp, **kw)
        assert segs[0][0] == 0 and segs[-1][1] == T

    labels = resolve_labels('english_lowercase')
    ix = {ch: i for i, ch in enumerate(labels)}
    frames = []
    for word in 'the cat sat on a mat'.split():
        for ch in word + ' ':
            row = np.full(len(labels), 1e-4)
            row[ix[ch]] = 0.8 + 0.1 * rng.random()
            frames.append(row)
        for _ in range(int(rng.integers(5, 40))):
            row = np.full(len(labels), 1e-4)
            row[0] = 0.95
            frames.append(row)
    probs = np.stack(frames)
    probs /= probs.sum(-1, keepdims=True)
    logp = np.log(probs).astype(np.float32)
    got = longform.decode_segmented(
        logp, PrefixBeamSearchLMDecoder('', labels, k=8, alpha=0.0,
                                        beta=0.0))
    want = jlong.decode_segmented(logp, JaxBeam('', labels, k=8, alpha=0.0,
                                                beta=0.0))
    assert got == want == 'the cat sat on a mat'


@pytest.fixture(scope='module')
def artifact(small, tmp_path_factory):
    """A port artifact of the small stack (int8 with static scales and
    CMVN) and a 60 000-sample WAV."""
    root = tmp_path_factory.mktemp('longform_cli')
    rng = np.random.default_rng(17)
    scales = serving.calibrate_activation_scales(
        SMALL_LAYERS, small, _fe(),
        (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32),
        np.array([24000, 20000]))
    stats = (np.zeros(N_MELS, np.float32), np.ones(N_MELS, np.float32))
    art = serving.export_serving(
        str(root / 'art'), SMALL_LAYERS, 7, None, labels=LABELS,
        audio_conf=AUDIO_CONF, weights='int8', folded=small,
        norm_stats=stats, act_scales=scales)
    wav = str(root / 'long.wav')
    write_wav(wav, _audio(60000, seed=21), 16000)
    return art, wav, root


def _run(argv, capsys):
    assert long_cli.main(argv + ['--device', 'cpu']) == 0
    out = capsys.readouterr().out.splitlines()
    return json.loads(out[0]), out[1:]


@pytest.mark.parametrize('extra', [[], ['--int8-full'],
                                   ['--norm', 'cmvn']])
def test_transcribe_long_cli(artifact, capsys, extra):
    """--verify-oneshot holds the chunked output to the one-shot forward
    of the same audio, and --word-timings gives ordered words inside the
    recording."""
    art, wav, root = artifact
    out = str(root / 'r.json')
    result, text = _run(['--artifact', art, '--audio', wav, '--chunk-frames',
                         '40', '--max-batch', '3', '--verify-oneshot',
                         '--word-timings', '--json-out', out, *extra],
                        capsys)
    assert result['mode'] == ('int8_full' if extra == ['--int8-full']
                              else 'int8')
    assert result['oneshot_max_abs_diff'] <= (
        0.0 if extra == ['--int8-full'] else EXACT_TOL)
    assert result['oneshot_argmax_equal'] and result['device'] == 'cpu'
    assert len(text) == 1 and result['transcript_chars'] == len(text[0])
    with open(out) as f:
        rec = json.load(f)
    assert rec['num_words_timed'] == len(rec['word_timings'])
    prev = -1.0
    for word, start, end in rec['word_timings']:
        assert word and ' ' not in word
        assert 0 <= start <= end <= 60000 / 16000 + 0.1 and start >= prev
        prev = start


@pytest.fixture(scope='module')
def jax_long_script():
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    try:
        import transcribe_long as script
    finally:
        sys.path.pop(0)
    return script


def test_transcribe_long_cli_concat_hotwords_and_refusals(artifact, capsys,
                                                         tmp_path,
                                                         jax_long_script):
    art, wav, _ = artifact
    manifest = tmp_path / 'm.jsonl'
    manifest.write_text('\n'.join(json.dumps(
        {'audio_filepath': wav, 'text': t}) for t in ('abba', 'dad')))
    result, text = _run(['--artifact', art, '--concat-manifest',
                         str(manifest), '--minutes', '0.1', '--hotwords',
                         'abba,dad', '--chunk-frames', '40'], capsys)
    assert result['decode'] == 'beam_lm' and not text
    assert result['audio_seconds'] == 7.5
    assert 0 <= result['cer'] and 0 <= result['wer']
    # A FLAC file and an 8 kHz WAV transcribe as the JAX script
    # transcribes them (FLAC decoded, 8 kHz resampled to the artifact's
    # 16 kHz); a stub FLAC raises the JAX decoder's error.
    flac = str(tmp_path / 'x.flac')
    write_flac_file(flac, _audio(30000, seed=5), 16000)
    wav8k = str(tmp_path / 'x8k.wav')
    write_wav(wav8k, _audio(16000, seed=6), 8000)
    for audio in (flac, wav8k):
        result, text = _run(['--artifact', art, '--audio', audio,
                             '--chunk-frames', '40'], capsys)
        assert jax_long_script.main(['--artifact', art, '--audio', audio,
                                     '--chunk-frames', '40']) == 0
        out = capsys.readouterr().out.splitlines()
        want = json.loads(next(l for l in out if l.startswith('{')))
        assert result['audio_seconds'] == want['audio_seconds']
        assert text == out[-1:] and result['transcript_chars'] == \
            want['transcript_chars']
    stub = tmp_path / 'stub.flac'
    stub.write_bytes(b'fLaC' + bytes(60))
    with pytest.raises(ValueError) as want:
        jax_read_audio(str(stub))
    with pytest.raises(ValueError, match=f'^{want.value}$'):
        long_cli.main(['--artifact', art, '--device', 'cpu', '--audio',
                       str(stub)])
    # --mesh: the windows over parallel.device_mesh (one CPU here)
    plain = _run(['--artifact', art, '--audio', wav, '--chunk-frames', '40'],
                 capsys)
    meshed = _run(['--artifact', art, '--audio', wav, '--chunk-frames', '40',
                   '--mesh'], capsys)
    for result, _ in (plain, meshed):
        for key in ('wall_seconds', 'x_realtime'):
            result.pop(key)
    assert meshed == plain
    with pytest.raises(SystemExit, match='need --audio'):
        long_cli.main(['--artifact', art, '--device', 'cpu'])
