"""TCP transport for live-stream transcription (StreamMultiplexer wiring).

The counterpart of the JAX package's ``serving/net.py``, with the same
wire protocol and error texts: many live audio connections multiplexed
into ONE batched streaming session on one device (``server.py``), so
concurrency scales with batch efficiency instead of with threads.

- **stdlib only** (asyncio + struct + json): a framed TCP protocol needs
  nothing more, and anything HTTP/gRPC can be layered on by a gateway.
- **One event loop owns the card.** Connection handlers parse frames and
  buffer audio (feeding may run the one-row prime); steady-state stepping
  and finish flushes happen in the server's tick task through
  ``StreamMultiplexer.tick_ready()``, which steps exactly the slots
  holding a full chunk, so one lagging client never stalls the batch.
- **Backpressure by slots.** A full server refuses the (slots+1)-th
  stream with a BUSY error instead of queueing without bound.

Wire protocol — every frame is ``u32 big-endian length | 1 type byte |
body``:

  client -> server
    0x01 HELLO  JSON {"sample_rate": int, "format": "f32"|"s16"}
                (a sample_rate differing from the model's is accepted:
                the server converts with a chunk-exact streaming
                polyphase resampler, data/resample.py)
    0x02 AUDIO  raw little-endian PCM in the declared format
    0x03 END    empty body: all audio sent, flush and return the final
  server -> client
    0x81 READY    JSON {"slot", "sample_rate", "input_rate",
                        "chunk_samples", "prime_samples"}
    0x82 PARTIAL  JSON {"text": fresh_suffix}
    0x83 FINAL    JSON {"text": full_transcript}
    0x84 ERROR    JSON {"error": message}  (connection closes after)

``StreamClient`` is the matching synchronous client (tests, demos,
non-asyncio callers).
"""

from __future__ import annotations

import asyncio
import json
import struct

import numpy as np

from .server import StreamMultiplexer

# Frame types.
HELLO, AUDIO, END = 0x01, 0x02, 0x03
READY, PARTIAL, FINAL, ERROR = 0x81, 0x82, 0x83, 0x84

_MAX_FRAME = 1 << 24  # 16 MiB: > 8 minutes of f32 16 kHz audio per frame


def _pack(ftype: int, body: bytes = b'') -> bytes:
    return struct.pack('>I', 1 + len(body)) + bytes([ftype]) + body


def _pack_json(ftype: int, obj) -> bytes:
    return _pack(ftype, json.dumps(obj).encode())


async def _read_frame(reader):
    """Read one frame; returns (type, body) or None on clean EOF."""
    try:
        head = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (n,) = struct.unpack('>I', head)
    if not 1 <= n <= _MAX_FRAME:
        raise ValueError(f'bad frame length {n}')
    try:
        payload = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return payload[0], payload[1:]


def _decode_audio(body: bytes, fmt: str) -> np.ndarray:
    if fmt == 'f32':
        return np.frombuffer(body, '<f4').astype(np.float32)
    # s16: scale to [-1, 1) the way audio_io does for 16-bit WAV.
    return np.frombuffer(body, '<i2').astype(np.float32) / 32768.0


class _Conn:
    """Per-connection state the tick loop advances."""

    def __init__(self, slot, writer, fmt, resampler=None):
        self.slot = slot
        self.writer = writer
        self.fmt = fmt
        self.resampler = resampler  # StreamingResampler | None (rate match)
        self.sent_chars = 0   # of mux.text(slot) already pushed as PARTIAL
        self.ending = False   # END received; flush + FINAL when drained
        self.done = asyncio.Event()


class StreamingServer:
    """Serve a streaming model over TCP on ``host:port``.

    ``model``: a ``StreamingWav2Letter`` or ``StreamingJasper`` (on the
    device it serves from), or with ``mesh`` one a device of the mesh
    (``StreamMultiplexer``).
    ``labels``: decode alphabet (blank at 0, as everywhere else).
    ``slots``: concurrent-stream capacity (= batch rows of the one
    batched streaming step).
    ``poll``: tick-loop sleep when no slot is steppable; defaults to a
    quarter chunk of audio time, floored at 1 ms.
    ``mesh``: a ``parallel.Mesh`` to split the slot batch over
    (``StreamMultiplexer``'s mesh mode: no collectives, n devices serve n
    times the streams of one).
    """

    def __init__(self, model, labels, slots: int = 16,
                 host: str = '127.0.0.1', port: int = 0,
                 poll: float | None = None, mesh=None):
        self.mux = StreamMultiplexer(model, slots=slots, labels=labels,
                                     mesh=mesh)
        model = self.mux.m
        self.sample_rate = model.sample_rate
        self.host, self.port = host, port
        cs = model.chunk_samples
        self.poll = poll if poll is not None else max(
            0.001, cs / self.sample_rate / 4)
        self._conns: dict[int, _Conn] = {}
        self._server = None
        self._tick_task = None

    # -- lifecycle -----------------------------------------------------

    async def start(self):
        """Bind and start serving; returns once listening (port is then
        available as ``self.port``)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._tick_task = asyncio.ensure_future(self._tick_loop())
        return self

    async def stop(self):
        self._tick_task.cancel()
        try:
            await self._tick_task
        except asyncio.CancelledError:
            pass
        self._server.close()
        await self._server.wait_closed()
        for conn in list(self._conns.values()):
            self._drop(conn)

    async def serve_forever(self):
        await self.start()
        await self._server.serve_forever()

    # -- connection handler (parsing + buffering only) -----------------

    async def _handle(self, reader, writer):
        conn = None
        try:
            frame = await _read_frame(reader)
            if frame is None or frame[0] != HELLO:
                writer.write(_pack_json(ERROR, {'error': 'expected HELLO'}))
                return
            hello = json.loads(frame[1].decode())
            fmt = hello.get('format', 'f32')
            if fmt not in ('f32', 's16'):
                writer.write(_pack_json(
                    ERROR, {'error': f'unknown format {fmt!r}'}))
                return
            client_rate = int(hello.get('sample_rate') or 0)
            if client_rate <= 0:
                writer.write(_pack_json(ERROR, {
                    'error': f'bad sample_rate {hello.get("sample_rate")!r}'}))
                return
            resampler = None
            if client_rate != self.sample_rate:
                # Rate-mismatched clients are converted server-side with
                # the stateful polyphase resampler (data/resample.py) —
                # chunk-exact vs one-shot conversion, so transcripts match
                # a client that resampled before sending.
                from ..data.resample import StreamingResampler
                resampler = StreamingResampler(client_rate, self.sample_rate)
            try:
                slot = self.mux.attach()
            except RuntimeError:
                writer.write(_pack_json(
                    ERROR, {'error': f'busy: all {self.mux.slots} slots '
                                     'in use'}))
                return
            conn = _Conn(slot, writer, fmt, resampler)
            self._conns[slot] = conn
            writer.write(_pack_json(READY, {
                'slot': slot, 'sample_rate': self.sample_rate,
                'input_rate': client_rate,
                'chunk_samples': self.mux.m.chunk_samples,
                'prime_samples': self.mux.m.prime_samples}))
            await writer.drain()

            while True:
                frame = await _read_frame(reader)
                if frame is None:          # client vanished mid-stream
                    self._drop(conn)
                    return
                ftype, body = frame
                if ftype == AUDIO:
                    if conn.ending:
                        raise ValueError('AUDIO after END')
                    audio = _decode_audio(body, fmt)
                    if conn.resampler is not None:
                        audio = conn.resampler.push(audio)
                    if len(audio):
                        self.mux.feed(slot, audio)
                    self._push_partial(conn)
                elif ftype == END:
                    if conn.resampler is not None:
                        tail = conn.resampler.flush()
                        if len(tail):
                            self.mux.feed(slot, tail)
                    if not self.mux.primed(slot):
                        self._drop(conn)
                        writer.write(_pack_json(ERROR, {
                            'error': 'stream shorter than the prime '
                                     'window; use the offline path'}))
                        await writer.drain()
                        return
                    conn.ending = True
                    await conn.done.wait()  # tick loop flushes + FINALs
                    return
                else:
                    raise ValueError(f'unexpected frame type {ftype:#x}')
        except (ValueError, json.JSONDecodeError) as e:
            if conn is not None:
                self._drop(conn)
            try:
                writer.write(_pack_json(ERROR, {'error': str(e)}))
                await writer.drain()
            except ConnectionError:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    # -- tick loop (owns every device step after prime) ---------------

    async def _tick_loop(self):
        while True:
            stepped = {}
            try:
                stepped = self.mux.tick_ready()
                for slot in stepped:
                    conn = self._conns.get(slot)
                    if conn is not None:
                        self._push_partial(conn)
                # Flush ending streams whose buffers have drained below a
                # chunk: finish program + FINAL frame.
                for conn in list(self._conns.values()):
                    if (conn.ending and not conn.done.is_set()
                            and self.mux.pending(conn.slot)
                            < self.mux.m.chunk_samples):
                        try:
                            text = self.mux.detach(conn.slot)
                            conn.writer.write(
                                _pack_json(FINAL, {'text': text}))
                        except Exception as e:   # keep serving others
                            conn.writer.write(
                                _pack_json(ERROR, {'error': str(e)}))
                            self.mux.abort(conn.slot)
                        del self._conns[conn.slot]
                        conn.done.set()
            except asyncio.CancelledError:
                raise
            except Exception:
                # A tick-loop death would hang every connection; log and
                # keep ticking (per-stream failures are handled above).
                import traceback
                traceback.print_exc()
            if stepped:
                await asyncio.sleep(0)      # yield; drain fast feeders
            else:
                await asyncio.sleep(self.poll)

    # -- helpers -------------------------------------------------------

    def _push_partial(self, conn):
        full = self.mux.text(conn.slot)
        fresh = full[conn.sent_chars:]
        if fresh:
            conn.sent_chars = len(full)
            conn.writer.write(_pack_json(PARTIAL, {'text': fresh}))

    def _drop(self, conn):
        """Free a connection's slot without flushing (abort path)."""
        self._conns.pop(conn.slot, None)
        self.mux.abort(conn.slot)
        conn.done.set()


class StreamClient:
    """Synchronous client for :class:`StreamingServer` (blocking socket).

    >>> c = StreamClient(host, port)
    >>> c.send(audio_chunk); ...
    >>> final = c.finish()          # -> full transcript
    >>> c.partials                  # incremental texts seen along the way
    """

    def __init__(self, host: str, port: int, sample_rate: int = 16000,
                 fmt: str = 'f32', timeout: float = 30.0):
        import socket
        self.fmt = fmt
        self.timeout = timeout
        self.partials: list[str] = []
        self._rbuf = b''   # received-but-unparsed bytes (frame reassembly)
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.sendall(_pack_json(HELLO, {'sample_rate': sample_rate,
                                             'format': fmt}))
        ftype, body = self._read()
        if ftype == ERROR:
            raise RuntimeError(json.loads(body)['error'])
        assert ftype == READY, f'expected READY, got {ftype:#x}'
        self.info = json.loads(body)

    def send(self, audio) -> None:
        a = np.asarray(audio).ravel()
        if self.fmt == 'f32':
            body = a.astype('<f4').tobytes()
        else:
            body = np.clip(a * 32768.0, -32768, 32767) \
                .astype('<i2').tobytes()
        self.sock.sendall(_pack(AUDIO, body))
        self._drain_partials(block=False)

    def finish(self) -> str:
        """Signal end-of-stream; block until the FINAL transcript."""
        self.sock.sendall(_pack(END))
        while True:
            ftype, body = self._read()
            if ftype == PARTIAL:
                self.partials.append(json.loads(body)['text'])
            elif ftype == FINAL:
                self.close()
                return json.loads(body)['text']
            elif ftype == ERROR:
                self.close()
                raise RuntimeError(json.loads(body)['error'])

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    # -- internals -----------------------------------------------------
    # All receiving goes through self._rbuf so a partially-arrived frame
    # seen during a non-blocking drain is reassembled, never desynced.

    def _pop_frame(self):
        """Parse one complete frame out of the buffer, or None."""
        if len(self._rbuf) < 4:
            return None
        (n,) = struct.unpack('>I', self._rbuf[:4])
        if len(self._rbuf) < 4 + n:
            return None
        payload, self._rbuf = self._rbuf[4:4 + n], self._rbuf[4 + n:]
        return payload[0], payload[1:]

    def _read(self):
        """Blocking: next complete frame."""
        while True:
            frame = self._pop_frame()
            if frame is not None:
                return frame
            part = self.sock.recv(65536)
            if not part:
                raise ConnectionError('server closed the connection')
            self._rbuf += part

    def _drain_partials(self, block: bool) -> None:
        """Opportunistically consume available PARTIAL frames."""
        self.sock.setblocking(False)
        try:
            try:
                while True:
                    part = self.sock.recv(65536)
                    if not part:
                        break
                    self._rbuf += part
            except (BlockingIOError, InterruptedError):
                pass
        finally:
            self.sock.setblocking(True)
            self.sock.settimeout(self.timeout)
        while True:
            frame = self._pop_frame()
            if frame is None:
                return
            ftype, body = frame
            if ftype == PARTIAL:
                self.partials.append(json.loads(body)['text'])
            elif ftype == ERROR:
                raise RuntimeError(json.loads(body)['error'])
