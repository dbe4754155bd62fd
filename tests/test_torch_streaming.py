"""The port's streaming serving path vs the JAX package's, on the CPU.

``serving/streaming.py`` (the exact chunked streamer, its transcribers),
``lookahead.py``, ``endpoint.py`` and ``data/resample.py`` of the port are
held against the JAX modules of the same names on the same seeded weights
(``weights.state_dict_from_flax``) and the same numpy audio, fed in the
same pieces. The models are the JAX streaming tests' (``tests/
test_streaming.py``: ``SMALL_LAYERS``, the Wav2Letter-20 layout at width
16, 8 mel bands; ``tests/test_streaming_jasper.py``'s small Jasper).
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import (FLAGSHIP_STRUCTURE, HOP, N_MELS,
                                  SMALL_LAYERS, _build)
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data import resample as jresample
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu.serving import lookahead as jlook
from wav2letter_pytorch_tpu_torch import parallel, serving
from wav2letter_pytorch_tpu_torch.data import resample
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.models.jasper import Jasper
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.serving import lookahead, streaming
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

LABELS = ['_', 'a', 'b', 'c', 'd', 'e', ' ']
CPU = 'cpu'
STATS = (np.zeros(N_MELS, np.float32), np.ones(N_MELS, np.float32))
# Port stream vs JAX stream, f32 log-probs: float32 convs summed in
# another order (and K1's plain DFT against JAX's DFT conv); ~1e-6 seen.
STREAM_TOL = 1e-5
# The port's stream vs the port's offline forward, as the JAX package's
# own streaming tests hold its stream to its offline forward.
OFFLINE_TOL = 5e-4
# int8_full: the int32 sums are equal and the scales divide as JAX's, so
# only float32 steps between layers may round apart; one int8 rounding
# flip would show as ~1e-2.
Q8_TOL = 1e-5
# Bounded lookahead, port vs JAX (the model over each window).
LOOKAHEAD_TOL = 1e-4


@pytest.fixture(scope='module')
def small():
    """(JAX variables, the port's Wav2Letter) of SMALL_LAYERS."""
    _, variables, _ = _build(SMALL_LAYERS)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = Wav2Letter(len(LABELS), input_size=N_MELS, layers=SMALL_LAYERS,
                       mid_layers=len(SMALL_LAYERS))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return variables, model.eval()


def _frontends(stats=None, conf=None, feature_type='logmel'):
    conf = conf or {}
    return (JaxFrontend(JaxAudio(**conf), n_mels=N_MELS, dither=0.0,
                        norm_stats=stats, feature_type=feature_type),
            SpectrogramFrontend(AudioConfig(**conf), n_mels=N_MELS,
                                dither=0.0, norm_stats=stats,
                                feature_type=feature_type))


def _streamers(layers, variables, model, stats=STATS,
               feature_type='logmel', **kw):
    """The JAX streamer and the port's on the same weights."""
    jfe, fe = _frontends(stats, feature_type=feature_type)
    norm = dict(norm='precomputed', norm_stats=stats) if stats is not None \
        else dict(norm='cumulative')
    kw = {**norm, **kw}
    return (jserve.StreamingWav2Letter(layers, len(LABELS), variables, jfe,
                                       **kw),
            streaming.StreamingWav2Letter(layers, len(LABELS), model, fe,
                                          device=CPU, **kw))


def _audio(lengths, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((len(lengths), max(lengths))) * scale) \
        .astype(np.float32)
    for b, L in enumerate(lengths):
        audio[b, L:] = 0.0
    return audio


def _run(sw, audio, lengths, piece=1777):
    """Feed in awkward pieces; (emitted log-probs, total valid [B])."""
    sess = sw.start(audio.shape[0])
    outs = [sess.feed(audio[:, s:s + piece])
            for s in range(0, int(np.max(lengths)), piece)]
    fin, valid = sess.finish(np.asarray(lengths))
    emitted = np.concatenate([np.asarray(o) for o in outs if o.shape[1]]
                             + [np.asarray(fin)], axis=1)
    return emitted, sess.head_frames_emitted + np.asarray(valid)


def _offline_pad(sw, length, scale=2):
    """Zero-padded length beyond the lookahead, a frame count divisible by
    the stride (the JAX streaming tests' offline regime)."""
    pad = length + (sw.lookahead_frames + 8) * HOP
    pad += HOP - pad % HOP
    while (1 + pad // HOP) % scale:
        pad += HOP
    return pad


def _port_offline(sw, layers, audio, lengths, padding_mode='reflect'):
    """The port's offline serving forward on the streamer's own fold."""
    pad = _offline_pad(sw, int(np.max(lengths)))
    buf = np.zeros((audio.shape[0], pad), np.float32)
    buf[:, :audio.shape[1]] = audio
    with torch.no_grad():
        feats, flens = sw.frontend(torch.from_numpy(buf),
                                   torch.tensor(lengths))
        logp, lens = serving.offline_forward(layers, sw._folded, feats,
                                             flens, padding_mode=padding_mode)
    return logp.numpy(), lens.numpy()


def _geometry(sw):
    return (sw.prime_frames, sw.prime_out, sw.chunk_out, sw.lookahead_frames,
            sw._carries, sw._prime_outs, sw._chunk_outs, sw._fin_zeros,
            sw._fin_flush, sw._fin_out, sw._fin_frames, sw.scale)


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4])
def test_plan_and_geometry_equal_jax_fuzz(seed):
    """``_plan``, the prime search and the finish flush search over the
    layer geometries of ``tests/test_streaming.py::test_stream_plan_fuzz``
    (the same draws), on random folded weights."""
    rng = np.random.default_rng(100 + seed)
    n_layers = int(rng.integers(2, 5))
    layers, scale = [], 1
    for li in range(n_layers):
        s = int(rng.choice([1, 1, 2])) if li == 0 else 1
        layers.append({'output_size': 8,
                       'kernel_size': int(rng.integers(2, 14)),
                       'stride': s,
                       'dilation': int(rng.choice([1, 1, 2, 3]))})
        scale *= s
    pad_mode = str(rng.choice(['reflect', 'zeros']))
    folded, cin = [], N_MELS
    for l in layers + [{'output_size': 7, 'kernel_size': 1}]:
        w = rng.standard_normal((l['kernel_size'], cin, l['output_size']))
        folded.append((w.astype(np.float32),
                       np.zeros(l['output_size'], np.float32)))
        cin = l['output_size']
    for chunk in (8 * scale, 16 * scale):
        jsw, sw = _streamers(layers, None, None, chunk_frames=chunk,
                             folded=folded, padding_mode=pad_mode)
        assert _geometry(sw) == _geometry(jsw)
        for specs in (sw._specs, jsw._specs):
            assert [sp.pad_mode for sp in specs[1:]] == [pad_mode] * (
                n_layers + 1)
        for p in (sw.prime_samples - 1, sw.prime_samples,
                  2 * sw.prime_samples):
            assert (streaming._plan(sw._specs, p, sw.chunk_samples)
                    == jserve.streaming._plan(jsw._specs, p,
                                              jsw.chunk_samples))


STREAM_CASES = [
    # (padding, norm, chunk_frames, tail offsets, n_chunks, piece)
    ('reflect', 'precomputed', 16, [1311, 707], 3, 1777),
    ('zeros', 'precomputed', 10, [1555, 640], 3, 503),
    ('reflect', 'precomputed', 16, [0, 2559], 2, 1777),   # chunk boundary
    ('reflect', 'cumulative', 10, [1000, 321], 4, 7919),
    ('zeros', 'cumulative', 16, [2559, 0], 2, 1234),
]


@pytest.mark.parametrize('padding, norm, chunk, tails, n_chunks, piece',
                         STREAM_CASES)
def test_stream_matches_jax(small, padding, norm, chunk, tails, n_chunks,
                            piece):
    """f32 streams, two rows ending anywhere in the final chunk (one
    exactly on a chunk boundary), fed in awkward pieces: the emitted
    log-probs within STREAM_TOL of JAX's, the valid counts equal; with
    fixed statistics, within OFFLINE_TOL of the port's offline forward."""
    variables, model = small
    stats = STATS if norm == 'precomputed' else None
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, stats,
                         chunk_frames=chunk, padding_mode=padding)
    assert _geometry(sw) == _geometry(jsw)
    lengths = [sw.prime_samples + n_chunks * sw.chunk_samples + t
               for t in tails]
    audio = _audio(lengths, seed=42)
    got, valid = _run(sw, audio, lengths, piece)
    want, want_valid = _run(jsw, audio, lengths, piece)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(valid, (1 + np.asarray(lengths) // HOP)
                                  // 2)
    assert got.shape == want.shape
    for b, v in enumerate(valid):
        np.testing.assert_allclose(got[b, :v], want[b, :v], rtol=0,
                                   atol=STREAM_TOL)
    if stats is not None:
        off, off_lens = _port_offline(sw, SMALL_LAYERS, audio, lengths,
                                      padding)
        np.testing.assert_array_equal(off_lens, valid)
        for b, v in enumerate(valid):
            np.testing.assert_allclose(got[b, :v], off[b, :v],
                                       atol=OFFLINE_TOL, rtol=1e-4)


@pytest.mark.parametrize('norm', ['precomputed', 'cumulative'])
def test_mfcc_stream_matches_jax(small, norm):
    """MFCC features (the DCT after K1 in every phase): the stream within
    STREAM_TOL of JAX's MFCC stream and, with fixed statistics, within
    OFFLINE_TOL of the port's offline MFCC forward."""
    variables, model = small
    stats = STATS if norm == 'precomputed' else None
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, stats,
                         feature_type='mfcc', chunk_frames=10)
    np.testing.assert_array_equal(sw.frontend.dct.numpy(),
                                  jsw._dct)
    lengths = [sw.prime_samples + 3 * sw.chunk_samples + t
               for t in (1000, 0)]
    audio = _audio(lengths, seed=43)
    got, valid = _run(sw, audio, lengths, 2345)
    want, want_valid = _run(jsw, audio, lengths, 2345)
    np.testing.assert_array_equal(valid, want_valid)
    for b, v in enumerate(valid):
        np.testing.assert_allclose(got[b, :v], want[b, :v], rtol=0,
                                   atol=STREAM_TOL)
    if stats is not None:
        off, off_lens = _port_offline(sw, SMALL_LAYERS, audio, lengths)
        np.testing.assert_array_equal(off_lens, valid)
        for b, v in enumerate(valid):
            np.testing.assert_allclose(got[b, :v], off[b, :v],
                                       atol=OFFLINE_TOL, rtol=1e-4)


def test_mfcc_bounded_lookahead_matches_jax(small):
    from wav2letter_pytorch_tpu.models import Wav2Letter as JaxW2L
    variables, model = small
    jmodel = JaxW2L(layers=SMALL_LAYERS, num_labels=len(LABELS),
                    mid_layers=len(SMALL_LAYERS))
    specs = lookahead._conv_specs_w2l(SMALL_LAYERS)
    jfe, fe = _frontends(feature_type='mfcc')
    norm = dict(norm='precomputed', norm_stats=STATS)
    kw = dict(chunk_frames=32, lookahead_frames=16)
    jsw = jlook.BoundedLookaheadStreamer(jmodel, variables, jfe, specs,
                                         **norm, **kw)
    sw = lookahead.BoundedLookaheadStreamer(model, fe, specs, device=CPU,
                                            **norm, **kw)
    audio = _audio([199 * HOP], seed=1)
    np.testing.assert_allclose(
        lookahead.bounded_stream_logprobs(sw, audio, 3111),
        jlook.bounded_stream_logprobs(jsw, audio, 3111), rtol=0,
        atol=LOOKAHEAD_TOL)


def test_flagship_structure_matches_jax():
    """The Wav2Letter-20 layout at width 16: the static plan (prime 4 s+)
    equals JAX's and the stream its log-probs."""
    _, variables, _ = _build(FLAGSHIP_STRUCTURE, num_labels=7, seed=3)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = Wav2Letter(7, input_size=N_MELS, layers=FLAGSHIP_STRUCTURE,
                       mid_layers=len(FLAGSHIP_STRUCTURE))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    jsw, sw = _streamers(FLAGSHIP_STRUCTURE, variables, model,
                         chunk_frames=64)
    assert _geometry(sw) == _geometry(jsw) and sw.lookahead_frames > 300
    length = sw.prime_samples + sw.chunk_samples + 4321
    audio = _audio([length], seed=7)
    got, valid = _run(sw, audio, [length])
    want, want_valid = _run(jsw, audio, [length])
    assert int(valid[0]) == int(want_valid[0]) == (1 + length // HOP) // 2
    v = int(valid[0])
    np.testing.assert_allclose(got[0, :v], want[0, :v], rtol=0,
                               atol=STREAM_TOL)


def test_stream_features_equal_offline_frontend(small):
    """The streaming frontend (K1's plain version over the carried
    buffers) against the offline frontend on the same audio: every valid
    frame equal to 1e-6 (the frames are the same samples and the same
    per-frame DFT; only the matmul's blocking may differ)."""
    variables, model = small
    _, sw = _streamers(SMALL_LAYERS, variables, model, chunk_frames=16)
    L = sw.prime_samples + 3 * sw.chunk_samples + 1234
    audio = torch.from_numpy(_audio([L], seed=3))
    with torch.no_grad():
        last, carry, nstate, f0 = sw._fe_prime(audio[:, :sw.prime_samples])
        feats, off = [f0], sw.prime_samples
        for _ in range(3):
            last, carry, nstate, f = sw._fe_step(
                last, carry, nstate, audio[:, off:off + sw.chunk_samples])
            feats.append(f)
            off += sw.chunk_samples
        tail = torch.zeros(1, sw.chunk_samples)
        tail[:, :L - off] = audio[:, off:]
        f, valid = sw._fe_finish(last, carry, nstate, tail,
                                 torch.tensor([L - off]))
        got = torch.cat(feats + [f[:, :int(valid[0])]], dim=1)
        want, flens = sw.frontend(audio, torch.tensor([L]))
    assert got.shape[1] == int(flens[0]) == want.shape[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize('scales', ['dynamic', 'static'])
def test_int8_full_matches_jax(small, scales):
    """int8 weights and activations (VALID im2col x ``torch._int_mm``'s
    CPU path), dynamic and static scales: within Q8_TOL of JAX's stream,
    argmax equal."""
    variables, model = small
    folded = jserve.quantize_folded(jserve.fold_batchnorm(
        variables, len(SMALL_LAYERS)))
    act = None
    if scales == 'static':
        act = [0.02 + 0.01 * i for i in range(len(folded))]
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, chunk_frames=16,
                         folded=folded, weights='int8_full', act_scales=act)
    lengths = [sw.prime_samples + 2 * sw.chunk_samples + 999,
               sw.prime_samples + 2 * sw.chunk_samples + 17]
    audio = _audio(lengths, seed=9)
    got, valid = _run(sw, audio, lengths)
    want, want_valid = _run(jsw, audio, lengths)
    np.testing.assert_array_equal(valid, want_valid)
    for b, v in enumerate(valid):
        d = np.abs(got[b, :v] - want[b, :v]).max()
        assert d <= Q8_TOL, d
        np.testing.assert_array_equal(got[b, :v].argmax(-1),
                                      want[b, :v].argmax(-1))


@pytest.mark.parametrize('k, s, d, T', [(7, 2, 1, 40), (5, 1, 2, 33),
                                        (1, 1, 1, 3), (11, 1, 1, 11)])
def test_conv_q8_valid_accumulators_equal_jax(k, s, d, T):
    """The VALID int8 convolution's int32 accumulators equal JAX's
    ``conv_general_dilated(preferred_element_type=int32)`` exactly (M
    below and above ``int_mm``'s 17-row padding)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(k * 100 + T)
    x = rng.integers(-127, 128, (2, T, 12)).astype(np.int8)
    q = rng.integers(-127, 128, (k, 12, 16)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(q), window_strides=(s,),
        padding='VALID', rhs_dilation=(d,),
        dimension_numbers=('NWC', 'WIO', 'NWC'),
        preferred_element_type=jnp.int32)
    got = serving.infer.conv_q8_valid(torch.from_numpy(x),
                                      torch.from_numpy(q), s, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_weights_match_jax(small):
    """weights='int8' (quantized from the model, float32 math)."""
    variables, model = small
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, chunk_frames=16,
                         weights='int8')
    L = [sw.prime_samples + 2 * sw.chunk_samples + 500]
    audio = _audio(L, seed=4)
    got, valid = _run(sw, audio, L)
    want, _ = _run(jsw, audio, L)
    v = int(valid[0])
    np.testing.assert_allclose(got[0, :v], want[0, :v], rtol=0,
                               atol=STREAM_TOL)


def test_transcribers_equal_jax(small):
    """Greedy (with word timings) and beam (with hotwords) transcribers
    over the same streams give JAX's strings."""
    variables, model = small
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, chunk_frames=16)
    base = sw.prime_samples + 2 * sw.chunk_samples
    lengths = [base + 2000, base + 900]
    audio = _audio(lengths, seed=5, scale=0.3)
    results = []
    for mod, m in ((jserve.streaming, jsw), (streaming, sw)):
        greedy = mod.StreamingTranscriber(m.start(2), LABELS)
        beam = mod.StreamingBeamTranscriber(m.start(2), LABELS, k=4,
                                            prune=1e-4, hotwords=['abc'])
        for s in range(0, max(lengths), 1234):
            greedy.feed(audio[:, s:s + 1234])
            beam.feed(audio[:, s:s + 1234])
        results.append((greedy.finish(np.asarray(lengths)),
                        greedy.word_timings(0.02),
                        beam.finish(np.asarray(lengths)), beam.text))
    assert results[1] == results[0]
    assert any(results[0][0])
    # stream_logprobs: one utterance through a fresh session.
    one = audio[:1, :lengths[0]]
    np.testing.assert_allclose(streaming.stream_logprobs(sw, one),
                               jserve.streaming.stream_logprobs(jsw, one),
                               rtol=0, atol=STREAM_TOL)


class _FakeModel:
    emits_probs = True


class _FakeSession:
    """Replays crafted probability chunks through the transcriber API."""

    def __init__(self, chunks):
        self.m = _FakeModel()
        self.B = chunks[0].shape[0]
        self._chunks = list(chunks)

    def feed(self, _audio=None):
        return self._chunks.pop(0)

    def finish(self, lengths=None):
        out = (self._chunks.pop(0) if self._chunks
               else np.zeros((self.B, 0, len(LABELS)), np.float32))
        return out, np.full((self.B,), out.shape[1], np.int32)


@pytest.mark.parametrize('decoder', ['greedy', 'beam'])
def test_segmenting_transcriber_equals_jax(small, decoder):
    """Endpointing on random emissions with confident-blank runs (and on a
    real stream): the same segments, texts, frames and partials as JAX's,
    greedy and beam."""
    rng = np.random.default_rng(12)
    chunks = []
    for _ in range(6):
        logits = rng.standard_normal((2, 40, len(LABELS))) * 2.0
        logits[:, :, 0] += np.where(rng.random((2, 40, 1)) < 0.6, 9.0, 0.0)[
            ..., 0]
        p = np.exp(logits - logits.max(-1, keepdims=True))
        chunks.append((p / p.sum(-1, keepdims=True)).astype(np.float32))
    kw = dict(decoder=decoder, trailing_blank_frames=5, blank_threshold=0.9,
              max_segment_frames=60, k=4, prune=1e-4)
    outs = []
    for mod in (jserve.endpoint, serving.endpoint):
        seg = mod.SegmentingTranscriber(_FakeSession(chunks), LABELS, **kw)
        fed = [seg.feed(None) for _ in range(5)]
        partial = seg.partial
        fin = seg.finish()
        outs.append(([[[(s.text, s.start_frame, s.end_frame) for s in b]
                       for b in f] for f in fed + [fin]], partial,
                     seg.timings(0.02)))
    assert outs[1] == outs[0]
    assert sum(len(b) for f in outs[0][0] for b in f) >= 2
    variables, model = small
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, chunk_frames=16)
    L = sw.prime_samples + 3 * sw.chunk_samples + 700
    audio = _audio([L], seed=8, scale=0.3)
    texts = []
    for mod, m in ((jserve.endpoint, jsw), (serving.endpoint, sw)):
        seg = mod.SegmentingTranscriber(m.start(1), LABELS,
                                        blank_threshold=0.5,
                                        trailing_blank_frames=2,
                                        decoder=decoder, k=4)
        seg.feed(audio)
        seg.finish()
        texts.append([s.text for s in seg.segments[0]])
    assert texts[1] == texts[0]


def _lookahead_pair(jmodel, variables, model, specs, stats, **kw):
    jfe, fe = _frontends()
    norm = dict(norm='precomputed', norm_stats=stats)
    return (jlook.BoundedLookaheadStreamer(jmodel, variables, jfe, specs,
                                           **norm, **kw),
            lookahead.BoundedLookaheadStreamer(model, fe, specs, device=CPU,
                                               **norm, **kw))


@pytest.mark.parametrize('la, extrap, mode', [
    ('full', 0, 'reflect'), (16, 0, 'reflect'), (16, 24, 'reflect'),
    (16, 8, 'repeat')])
def test_bounded_lookahead_w2l_matches_jax(small, la, extrap, mode):
    """Bounded lookahead over Wav2Letter: the committed log-probs within
    LOOKAHEAD_TOL of JAX's, fed in odd pieces; a stream shorter than one
    frontend chunk too."""
    from wav2letter_pytorch_tpu.models import Wav2Letter as JaxW2L
    variables, model = small
    jmodel = JaxW2L(layers=SMALL_LAYERS, num_labels=len(LABELS),
                    mid_layers=len(SMALL_LAYERS))
    specs = lookahead._conv_specs_w2l(SMALL_LAYERS)
    assert specs == jlook._conv_specs_w2l(SMALL_LAYERS)
    rf = lookahead.one_sided_context(specs)
    assert rf == jlook.one_sided_context(specs)
    la = -(-rf // 2) * 2 + 2 if la == 'full' else la
    jsw, sw = _lookahead_pair(jmodel, variables, model, specs, STATS,
                              chunk_frames=32, lookahead_frames=la,
                              extrap_frames=extrap, extrap_mode=mode)
    audio = _audio([299 * HOP], seed=0)
    for piece in (None, 3111):
        got = lookahead.bounded_stream_logprobs(sw, audio, piece)
        want = jlook.bounded_stream_logprobs(jsw, audio, piece)
        assert got.shape == want.shape == (1, 150, len(LABELS))
        np.testing.assert_allclose(got, want, rtol=0, atol=LOOKAHEAD_TOL)
    short = audio[:, :3000]
    np.testing.assert_allclose(
        lookahead.bounded_stream_logprobs(sw, short),
        jlook.bounded_stream_logprobs(jsw, short), rtol=0,
        atol=LOOKAHEAD_TOL)


def test_bounded_lookahead_jasper_matches_jax():
    """Bounded lookahead over the small Jasper of ``tests/
    test_streaming_jasper.py`` (separable, residual add and max, a
    stride-2 entry): the committed probabilities within LOOKAHEAD_TOL of
    JAX's."""
    from tests.test_streaming_jasper import JASPER_SMALL
    from tests.test_streaming_jasper import _build as jasper_build
    jmodel, variables, _ = jasper_build(JASPER_SMALL)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = Jasper(JASPER_SMALL, 7, input_size=N_MELS,
                   mid_layers=len(JASPER_SMALL))
    model.load_state_dict(state_dict_from_flax(variables, JASPER_SMALL),
                          strict=True)
    specs = lookahead._conv_specs_jasper(JASPER_SMALL)
    assert specs == jlook._conv_specs_jasper(JASPER_SMALL)
    jsw, sw = _lookahead_pair(jmodel, variables, model, specs, STATS,
                              chunk_frames=16, lookahead_frames=8,
                              left_frames=16)
    assert sw.emits_probs
    audio = _audio([160 * HOP + 77], seed=1)
    got = lookahead.bounded_stream_logprobs(sw, audio, 2000)
    want = jlook.bounded_stream_logprobs(jsw, audio, 2000)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOOKAHEAD_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


RATE_PAIRS = [(8000, 16000), (48000, 16000), (44100, 16000),
              (16000, 22050)]


@pytest.mark.parametrize('orig, target', RATE_PAIRS)
def test_resample_bit_equal_jax(orig, target):
    """One shot and over ragged chunked pushes: the same float32 bits as
    the JAX module; the lowpass and the ratio equal too."""
    assert resample.resample_ratio(orig, target) == \
        jresample.resample_ratio(orig, target)
    up, down = resample.resample_ratio(orig, target)
    np.testing.assert_array_equal(resample.design_lowpass(up, down),
                                  jresample.design_lowpass(up, down))
    rng = np.random.default_rng(orig + target)
    x = rng.standard_normal(orig // 3 + 17).astype(np.float32)
    want = jresample.resample(x, orig, target)
    np.testing.assert_array_equal(resample.resample(x, orig, target), want)
    outs = {}
    for mod in (resample, jresample):
        r = mod.StreamingResampler(orig, target)
        parts, off, i = [], 0, 0
        while off < len(x):
            n = (1, 7, 1000, 333, 4096)[i % 5]
            parts.append(r.push(x[off:off + n]))
            off += n
            i += 1
        parts.append(r.flush())
        outs[mod.__name__] = np.concatenate(parts)
    got, jgot = outs[resample.__name__], outs[jresample.__name__]
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, want)


def test_streaming_errors_and_refusals(small, tmp_path):
    variables, model = small
    _, fe = _frontends()
    with pytest.raises(ValueError, match='divisible'):
        streaming.StreamingWav2Letter(SMALL_LAYERS, 7, model, fe,
                                      chunk_frames=15, device=CPU)
    with pytest.raises(ValueError, match='norm_stats'):
        streaming.StreamingWav2Letter(SMALL_LAYERS, 7, model, fe,
                                      chunk_frames=16, norm='precomputed',
                                      device=CPU)
    with pytest.raises(ValueError, match='int8_full'):
        streaming.StreamingWav2Letter(SMALL_LAYERS, 7, model, fe,
                                      chunk_frames=16, weights='int8_full',
                                      folded=serving.fold_batchnorm(model),
                                      device=CPU)
    # An MFCC frontend streams (its DCT after K1) as JAX's streamer does.
    jsw, sw = _streamers(SMALL_LAYERS, variables, model, None,
                         feature_type='mfcc', chunk_frames=16)
    assert sw.feat_dim == jsw.feat_dim == N_MELS
    lengths = [sw.prime_samples + 2 * sw.chunk_samples + 77]
    audio = _audio(lengths, seed=9)
    got, valid = _run(sw, audio, lengths)
    want, want_valid = _run(jsw, audio, lengths)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(got[0, :valid[0]], want[0, :valid[0]],
                               rtol=0, atol=STREAM_TOL)
    sw = streaming.StreamingWav2Letter(SMALL_LAYERS, 7, model,
                                       _frontends()[1], chunk_frames=16,
                                       device=CPU)
    sess = sw.start(1)
    sess.feed(np.zeros((1, 100), np.float32))
    with pytest.raises(ValueError, match='prime window'):
        sess.finish()
    with pytest.raises(ValueError, match=r'slots \(3\) must be divisible '
                       r'by the mesh size \(2\)'):
        serving.StreamMultiplexer(sw, slots=3, labels=LABELS,
                                  mesh=parallel.make_mesh(2, device='cpu'))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        streaming.StreamingWav2Letter(SMALL_LAYERS, 7, model,
                                      _frontends()[1], chunk_frames=16)
