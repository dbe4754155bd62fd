"""Serve a streaming artifact over TCP, or stream a WAV file to a server.

The port's counterpart of the JAX package's ``scripts/serve_tcp.py``, with
the same flags, plus ``--device``.

Server (up to ``--slots`` concurrent live streams batched into one
streaming session: ``serving/net.py``; with ``--mesh`` the slots split
over every visible GPU, ``parallel.device_mesh``):

    python -m wav2letter_pytorch_tpu_torch.serve_tcp --artifact ART \\
        --host 0.0.0.0 --port 7600 --slots 16 [--mesh] [--device cuda]

Client (sends a WAV file chunk by chunk, prints partials and the final):

    python -m wav2letter_pytorch_tpu_torch.serve_tcp --client audio.wav \\
        --port 7600 [--realtime]
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--artifact', help='serving artifact dir (server mode)')
    p.add_argument('--client', metavar='AUDIO',
                   help='WAV file to stream to a running server')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=7600)
    p.add_argument('--slots', type=int, default=16,
                   help='concurrent-stream capacity (batch rows)')
    p.add_argument('--mesh', action='store_true',
                   help='shard the slot batch across all local devices '
                        '(StreamMultiplexer mesh mode; slots must divide '
                        'by the device count)')
    p.add_argument('--chunk-frames', type=int, default=64,
                   help='feature frames per streaming step')
    p.add_argument('--realtime', action='store_true',
                   help='client: pace sends at real time instead of bulk')
    p.add_argument('--timeout', type=float, default=120.0,
                   help='client: socket timeout')
    p.add_argument('--device', default='cuda',
                   help='server: the device the streams run on')
    args = p.parse_args(argv)
    if bool(args.artifact) == bool(args.client):
        p.error('pass exactly one of --artifact (serve) / --client (send)')
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    return run_client(args) if args.client else run_server(args)


def build_server(args):
    """The ``StreamingServer`` of ``--artifact`` (not yet listening) and
    the artifact's meta."""
    from .parallel import device_mesh
    from .serving import StreamingServer, streaming_from_artifact
    mesh = device_mesh(args.device) if args.mesh else None
    # one streamer a device, each built there from the artifact
    built = [streaming_from_artifact(args.artifact,
                                     chunk_frames=args.chunk_frames, device=d)
             for d in (mesh.devices if mesh else [args.device])]
    _, labels, meta = built[0]
    srv = StreamingServer([m for m, _, _ in built], labels,
                          slots=args.slots, host=args.host, port=args.port,
                          mesh=mesh)
    return srv, meta


def run_server(args) -> int:
    import asyncio

    srv, meta = build_server(args)
    model = srv.mux.m
    chunk_s = model.chunk_samples / model.sample_rate
    where = srv.mux.mesh if srv.mux.mesh is not None else model.device
    print(f'serving {meta.get("family", "wav2letter")} '
          f'({meta["format"]} weights) on {args.host}:{args.port} '
          f'({where}): {args.slots} slots, {chunk_s * 1000:.0f} ms '
          f'chunks, {model.prime_samples / model.sample_rate:.2f} s prime '
          'window', flush=True)
    try:
        asyncio.run(srv.serve_forever())
    except KeyboardInterrupt:
        return 0
    return 0


def run_client(args) -> int:
    import numpy as np

    from .data.audio_io import read_wav
    from .serving import StreamClient

    audio, sr = read_wav(args.client)
    audio = np.asarray(audio, np.float32).ravel()
    c = StreamClient(args.host, args.port, sample_rate=sr,
                     timeout=args.timeout)
    cs = c.info['chunk_samples']
    print(f'streaming {len(audio) / sr:.2f} s '
          f'({len(audio)} samples) in {cs}-sample chunks', flush=True)
    seen = 0
    for i in range(0, len(audio), cs):
        c.send(audio[i:i + cs])
        if args.realtime:
            time.sleep(cs / sr)
        for t in c.partials[seen:]:
            print(f'partial: {t!r}', flush=True)
        seen = len(c.partials)
    final = c.finish()
    for t in c.partials[seen:]:
        print(f'partial: {t!r}', flush=True)
    print(f'final  : {final!r}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
