"""The port's stream multiplexer and TCP server vs the JAX package's, on
the CPU.

``serving/server.py`` (``StreamMultiplexer``) must transcribe exactly like
dedicated ``StreamingSession`` s of the port, and like the JAX multiplexer
on the same weights and schedule, through staggered attaches, starved
slots (``tick_ready``), aborts and slot reuse. ``serving/net.py``
(``StreamingServer``, ``StreamClient``) must give every client the
dedicated session's transcript (f32 and s16 wires, an 8 kHz client
resampled server-side, concurrent clients at different paces) and answer
protocol faults with the JAX server's error texts. The ``serve_tcp``
entry point serves an artifact and streams a WAV file to it. Servers bind
port 0 and stop their loop in teardown.
"""

import asyncio
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

from tests.test_streaming import N_MELS, SMALL_LAYERS, _build
from wav2letter_pytorch_tpu import serving as jserve
from wav2letter_pytorch_tpu.data.features import AudioConfig as JaxAudio
from wav2letter_pytorch_tpu.data.features import \
    SpectrogramFrontend as JaxFrontend
from wav2letter_pytorch_tpu_torch import parallel, serve_tcp, serving
from wav2letter_pytorch_tpu_torch.data.audio_io import write_wav
from wav2letter_pytorch_tpu_torch.data.features import (AudioConfig,
                                                        SpectrogramFrontend)
from wav2letter_pytorch_tpu_torch.data.resample import resample
from wav2letter_pytorch_tpu_torch.models.wav2letter import Wav2Letter
from wav2letter_pytorch_tpu_torch.serving.net import (END, ERROR, HELLO,
                                                      StreamClient,
                                                      StreamingServer,
                                                      _pack, _pack_json)
from wav2letter_pytorch_tpu_torch.weights import state_dict_from_flax

torch.set_num_threads(1)

LABELS = ['_', 'a', 'b', 'c', 'd', 'e', ' ']
SR = 16000
STATS = (np.zeros(N_MELS, np.float32), np.ones(N_MELS, np.float32))
SLOTS = 3


@pytest.fixture(scope='module')
def pair():
    """(JAX streamer, the port's streamer on the CPU, the port's model) on
    the same SMALL_LAYERS weights, chunk 16, fixed statistics."""
    _, variables, _ = _build(SMALL_LAYERS)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = Wav2Letter(len(LABELS), input_size=N_MELS, layers=SMALL_LAYERS,
                       mid_layers=len(SMALL_LAYERS))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    kw = dict(chunk_frames=16, norm='precomputed', norm_stats=STATS)
    jsw = jserve.StreamingWav2Letter(
        SMALL_LAYERS, len(LABELS), variables,
        JaxFrontend(JaxAudio(), n_mels=N_MELS, dither=0.0), **kw)
    sw = serving.StreamingWav2Letter(
        SMALL_LAYERS, len(LABELS), model.eval(),
        SpectrogramFrontend(AudioConfig(), n_mels=N_MELS, dither=0.0),
        device='cpu', **kw)
    return jsw, sw, model


def _dedicated(sw, audio, mod=serving):
    tr = mod.StreamingTranscriber(sw.start(1), LABELS)
    tr.feed(audio[None, :])
    return tr.finish(np.array([len(audio)]))[0]


def _streams(sw, seed, extra):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(sw.prime_samples + n) * 0.3)
            .astype(np.float32) for n in extra]


def _staggered(mod, sw, streams):
    """The JAX multiplexer test's schedule: staggered attach, one chunk a
    stream a tick, detach once drained."""
    cs, ps = sw.chunk_samples, sw.prime_samples
    mux = mod.StreamMultiplexer(sw, slots=4, labels=LABELS)
    lengths = [len(a) for a in streams]
    pos, slot, finals = [0] * 3, [None] * 3, [None] * 3
    attach_at = [0, 1, 3]
    partials = []
    for t in range(30):
        if all(f is not None for f in finals):
            break
        for i in range(3):
            if attach_at[i] == t:
                slot[i] = mux.attach()
                mux.feed(slot[i], streams[i][:ps + cs])
                pos[i] = ps + cs
        for i in range(3):
            if slot[i] is None or finals[i] is not None:
                continue
            if pos[i] < lengths[i]:
                mux.feed(slot[i], streams[i][pos[i]:pos[i] + cs])
                pos[i] += cs
            if pos[i] >= lengths[i] and mux.pending(slot[i]) < cs:
                finals[i] = mux.detach(slot[i])
        partials.append(mux.tick())
    for i in range(3):
        if finals[i] is None:
            finals[i] = mux.detach(slot[i])
    return finals, partials


def test_multiplexer_matches_dedicated_and_jax(pair):
    jsw, sw, _ = pair
    cs = sw.chunk_samples
    streams = _streams(sw, 21, [5 * cs + 700, 4 * cs + 1300, 3 * cs])
    got, got_partials = _staggered(serving, sw, streams)
    want, want_partials = _staggered(jserve, jsw, streams)
    assert got == [_dedicated(sw, a) for a in streams]
    assert got == want and got_partials == want_partials
    assert any(got)


def _starved(mod, sw, fast, slow):
    cs, ps = sw.chunk_samples, sw.prime_samples
    mux = mod.StreamMultiplexer(sw, slots=3, labels=LABELS)
    fa, sl = mux.attach(), mux.attach()
    mux.feed(fa, fast)
    mux.feed(sl, slow[:ps])
    stepped = mux.tick_ready()
    assert sl not in stepped and fa in stepped
    while mux.pending(fa) >= cs:
        mux.tick_ready()
    got_fast = mux.detach(fa)
    mux.feed(sl, slow[ps:])
    while mux.pending(sl) >= cs:
        mux.tick_ready()
    return [got_fast, mux.detach(sl)]


def test_tick_ready_skips_starved_slots_exactly(pair):
    """A starved slot's rows stay as they were (``torch.where``): its
    final still equals a dedicated session's, and JAX's."""
    jsw, sw, _ = pair
    cs = sw.chunk_samples
    fast, slow = _streams(sw, 11, [4 * cs + 100, 2 * cs + 900])
    got = _starved(serving, sw, fast, slow)
    assert got == [_dedicated(sw, fast), _dedicated(sw, slow)]
    assert got == _starved(jserve, jsw, fast, slow)


def test_multiplexer_abort_reuse_and_errors(pair):
    _, sw, _ = pair
    rng = np.random.default_rng(5)
    mux = serving.StreamMultiplexer(sw, slots=2, labels=LABELS)
    s = mux.attach()
    mux.feed(s, (rng.standard_normal(200) * 0.3).astype(np.float32))
    mux.abort(s)                  # unprimed abort
    audio = (rng.standard_normal(sw.prime_samples + 10) * 0.3) \
        .astype(np.float32)
    s2 = mux.attach()             # slot reusable, state reset
    assert s2 == s
    mux.feed(s2, audio)
    assert mux.detach(s2) == _dedicated(sw, audio)
    a, b = mux.attach(), mux.attach()
    with pytest.raises(RuntimeError, match='busy'):
        mux.attach()
    audio = (rng.standard_normal(sw.prime_samples + 300) * 0.3) \
        .astype(np.float32)
    mux.feed(a, audio)
    with pytest.raises(RuntimeError, match='starved'):
        mux.tick()
    assert mux.detach(a) == _dedicated(sw, audio)
    assert mux.attach() == a      # freed slot is reusable
    with pytest.raises(ValueError, match='prime window'):
        mux.detach(b)             # never primed
    mux.abort(b)
    with pytest.raises(ValueError, match='not attached'):
        mux.feed(b, audio)


def _serve(srv):
    """Run ``srv`` on its own event loop in a thread; returns a stopper."""
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        started.set()
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(60)

    def stop():
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(10)
        loop.close()
    return stop


@pytest.fixture(scope='module')
def server(pair):
    _, sw, _ = pair
    srv = StreamingServer(sw, LABELS, slots=SLOTS, poll=0.002)
    stop = _serve(srv)
    yield srv
    stop()


def _audio(rng, n):
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


def test_single_stream_roundtrip(server, pair):
    jsw, sw, _ = pair
    rng = np.random.default_rng(40)
    audio = _audio(rng, sw.prime_samples + 3 * sw.chunk_samples + 777)
    c = StreamClient('127.0.0.1', server.port, sample_rate=SR)
    assert c.info == {'slot': c.info['slot'], 'sample_rate': SR,
                      'input_rate': SR, 'chunk_samples': sw.chunk_samples,
                      'prime_samples': sw.prime_samples}
    for i in range(0, len(audio), 5000):
        c.send(audio[i:i + 5000])
    final = c.finish()
    assert final == _dedicated(sw, audio) == _dedicated(jsw, audio, jserve)
    assert final.startswith(''.join(c.partials))


def test_concurrent_clients_pacing_parity(server, pair):
    """Three clients: bulk, real-time paced, laggy; none corrupts another
    (``tick_ready`` isolation)."""
    _, sw, _ = pair
    rng = np.random.default_rng(41)
    cs, ps = sw.chunk_samples, sw.prime_samples
    streams = [_audio(rng, ps + 5 * cs + 123), _audio(rng, ps + 3 * cs + 1500),
               _audio(rng, ps + 2 * cs)]
    expected = [_dedicated(sw, a) for a in streams]
    finals = [None] * 3

    def client(i, piece, delay):
        c = StreamClient('127.0.0.1', server.port, sample_rate=SR)
        a = streams[i]
        for j in range(0, len(a), piece):
            c.send(a[j:j + piece])
            if delay:
                time.sleep(delay)
        finals[i] = c.finish()

    threads = [threading.Thread(target=client, args=(0, 1 << 30, 0)),
               threading.Thread(target=client, args=(1, cs, 0.01)),
               threading.Thread(target=client, args=(2, 900, 0.02))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert finals == expected


def test_s16_format(server, pair):
    _, sw, _ = pair
    rng = np.random.default_rng(42)
    audio = _audio(rng, sw.prime_samples + sw.chunk_samples + 50)
    q = np.clip(audio * 32768.0, -32768, 32767).astype('<i2') \
        .astype(np.float32) / 32768.0
    c = StreamClient('127.0.0.1', server.port, sample_rate=SR, fmt='s16')
    c.send(audio)
    assert c.finish() == _dedicated(sw, q)


def test_8khz_client_resampled_server_side(server, pair):
    """An 8 kHz client: the server's streaming resampler is chunk-exact,
    so the FINAL equals a dedicated session on the one-shot-resampled
    audio."""
    _, sw, _ = pair
    rng = np.random.default_rng(47)
    audio8 = _audio(rng, (sw.prime_samples + 2 * sw.chunk_samples) // 2
                    + 301)
    expected = _dedicated(sw, resample(audio8, 8000, SR))
    c = StreamClient('127.0.0.1', server.port, sample_rate=8000)
    assert c.info['input_rate'] == 8000 and c.info['sample_rate'] == SR
    for i in range(0, len(audio8), 1601):
        c.send(audio8[i:i + 1601])
    assert c.finish() == expected


def test_capacity_short_stream_and_disconnect(server, pair):
    """The (SLOTS+1)-th client gets BUSY; a stream shorter than the prime
    window gets its error and frees its slot; an abrupt disconnect frees
    its slot too."""
    _, sw, _ = pair
    rng = np.random.default_rng(43)
    audio = _audio(rng, sw.prime_samples + 10)
    held = [StreamClient('127.0.0.1', server.port, sample_rate=SR)
            for _ in range(SLOTS)]
    with pytest.raises(RuntimeError, match='busy'):
        StreamClient('127.0.0.1', server.port, sample_rate=SR)
    for c in held:
        c.send(audio)
        assert c.finish() == _dedicated(sw, audio)
    c = StreamClient('127.0.0.1', server.port, sample_rate=SR)
    c.send(_audio(rng, sw.prime_samples // 4))
    with pytest.raises(RuntimeError, match='prime window'):
        c.finish()
    c = StreamClient('127.0.0.1', server.port, sample_rate=SR)
    c.send(_audio(rng, sw.prime_samples + sw.chunk_samples))
    c.close()                       # vanish mid-stream, no END
    deadline = time.time() + 10     # the server notices EOF, aborts
    while True:
        try:
            busy = [StreamClient('127.0.0.1', server.port, sample_rate=SR)
                    for _ in range(SLOTS)]
            break
        except RuntimeError:
            assert time.time() < deadline, 'slot never freed'
            time.sleep(0.05)
    for b in busy:
        b.send(audio)
        assert b.finish() == _dedicated(sw, audio)


def _error_texts(port):
    """The ERROR texts a server sends for: END before HELLO, a HELLO that
    is not JSON, an unknown format, a bad sample rate, an unexpected frame
    type, a stream shorter than the prime window and the client beyond
    capacity."""
    texts = []

    def raw(*frames):
        s = socket.create_connection(('127.0.0.1', port), timeout=10)
        for f in frames:
            s.sendall(f)
        buf = b''
        while True:
            part = s.recv(4096)
            if not part:
                break
            buf += part
        s.close()
        while buf:
            n = int.from_bytes(buf[:4], 'big')
            if buf[4] == ERROR:
                texts.append(json.loads(buf[5:4 + n])['error'])
            buf = buf[4 + n:]

    hello = _pack_json(HELLO, {'sample_rate': SR, 'format': 'f32'})
    raw(_pack(END))
    raw(_pack(HELLO, b'{not json'))
    raw(_pack_json(HELLO, {'sample_rate': SR, 'format': 'f64'}))
    raw(_pack_json(HELLO, {'sample_rate': 0}))
    raw(hello, _pack(0x09))
    raw(hello, _pack(0x02, np.zeros(100, '<f4').tobytes()), _pack(END))
    held = [socket.create_connection(('127.0.0.1', port), timeout=10)
            for _ in range(SLOTS)]
    for s in held:
        s.sendall(hello)
        s.recv(4096)
    raw(hello)
    for s in held:
        s.close()
    return texts


def test_protocol_errors_are_jax_texts(server, pair):
    """Garbage frames and refusals: the same ERROR texts as the JAX
    server's, one for each fault."""
    jsw = pair[0]
    want_srv = jserve.StreamingServer(jsw, LABELS, slots=SLOTS, poll=0.002)
    stop = _serve(want_srv)
    try:
        want = _error_texts(want_srv.port)
    finally:
        stop()
    got = _error_texts(server.port)
    assert len(want) == 7 and got == want
    assert 'busy' in got[-1] and 'prime window' in got[-2]


def test_serve_tcp_entry_point(tmp_path, pair, capsys):
    """``serve_tcp`` serves a port artifact (f32 + CMVN) and its
    ``--client`` mode streams a WAV file to it: the FINAL printed is the
    dedicated session's on the artifact. ``--mesh`` serves the slots over
    ``parallel.device_mesh`` (one CPU here); slots the mesh does not
    divide are refused."""
    _, sw, model = pair
    art = serving.export_serving(
        str(tmp_path / 'art'), SMALL_LAYERS, len(LABELS), model,
        labels=LABELS, audio_conf={'sample_rate': SR, 'window_size': 0.02,
                                   'window_stride': 0.01,
                                   'window': 'hamming'},
        norm_stats=STATS)
    srv, meta = serve_tcp.build_server(serve_tcp.parse_args(
        ['--artifact', art, '--port', '0', '--slots', '2', '--chunk-frames',
         '16', '--device', 'cpu']))
    assert meta['format'] == 'f32' and srv.mux.slots == 2
    stop = _serve(srv)
    try:
        rng = np.random.default_rng(3)
        audio = _audio(rng, sw.prime_samples + 2 * sw.chunk_samples + 555)
        wav = str(tmp_path / 'a.wav')
        write_wav(wav, audio, SR)
        assert serve_tcp.main(['--client', wav, '--port',
                               str(srv.port)]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        from wav2letter_pytorch_tpu_torch.data.audio_io import read_wav
        want = _dedicated(srv.mux.m, read_wav(wav)[0])
        assert out[-1] == f'final  : {want!r}' and want
    finally:
        stop()
    srv, _ = serve_tcp.build_server(serve_tcp.parse_args(
        ['--artifact', art, '--port', '0', '--slots', '2', '--chunk-frames',
         '16', '--mesh', '--device', 'cpu']))
    assert srv.mux.mesh.devices == [torch.device('cpu')]
    stop = _serve(srv)
    try:
        assert serve_tcp.main(['--client', wav, '--port',
                               str(srv.port)]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert out[-1] == f'final  : {want!r}'
    finally:
        stop()
    with pytest.raises(ValueError, match='divisible'):
        StreamingServer(sw, LABELS, slots=3,
                        mesh=parallel.make_mesh(2, device='cpu'))
