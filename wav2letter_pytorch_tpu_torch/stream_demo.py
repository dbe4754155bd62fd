"""Stream one audio file through the streaming serving path, printing the
transcript as it grows, with each chunk's latency and the word timings.

    python -m wav2letter_pytorch_tpu_torch.stream_demo --model-path RUN \\
        --wav utt.wav [--device cuda]
    python -m wav2letter_pytorch_tpu_torch.stream_demo --model-path RUN \\
        --synthetic 6 --chunk-frames 64 --int8 --realtime

The port's counterpart of the JAX package's ``scripts/stream_demo.py``,
over the port's run directories (``training/build.py::load_run``), for
both families: a Wav2Letter run streams through ``StreamingWav2Letter``,
a Jasper / QuartzNet run through ``StreamingJasper`` (K1 a phase, K4 a
depthwise conv), with cumulative normalisation, f32 or ``--int8``
weights. ``--realtime`` sleeps between chunks to simulate a live
microphone; without it the stream is pushed as fast as the device drains
it.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Streaming ASR demo')
    parser.add_argument('--model-path', required=True,
                        help="the port's training run directory "
                             '(config.json + checkpoints/)')
    parser.add_argument('--wav', default='', help='WAV file to stream')
    parser.add_argument('--synthetic', type=float, default=0.0,
                        help='stream N seconds of synthetic audio instead')
    parser.add_argument('--chunk-frames', type=int, default=64)
    parser.add_argument('--int8', action='store_true',
                        help='int8 weights (float32 math)')
    parser.add_argument('--realtime', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help='the device the stream runs on')
    return parser.parse_args(argv)


def build_streamer(cfg, model, frontend, num_labels: int, chunk_frames: int,
                   int8: bool, device):
    """The exact streamer of the run's model family."""
    from .serving import StreamingJasper, StreamingWav2Letter
    mcfg = cfg['model']
    mid = int(mcfg['mid_layers'])
    kw = dict(chunk_frames=chunk_frames, weights='int8' if int8 else 'f32',
              device=device)
    if mcfg['name'] == 'jasper':
        return StreamingJasper([dict(b) for b in mcfg['jasper_blocks']][:mid],
                               num_labels, model, frontend, **kw)
    return StreamingWav2Letter(
        [dict(l) for l in mcfg['layers']][:mid], num_labels, model,
        frontend, padding_mode=mcfg.get('padding_mode', 'reflect'), **kw)


def read_audio(args, sample_rate: int) -> np.ndarray:
    if args.wav:
        from .data.audio_io import read_wav
        audio, sr = read_wav(args.wav)
        if sr != sample_rate:
            raise SystemExit(f'{args.wav}: {sr} Hz, the model takes '
                             f'{sample_rate} Hz')
        return np.asarray(audio, np.float32)
    if args.synthetic:
        t = np.arange(int(args.synthetic * sample_rate)) / sample_rate
        return (0.3 * np.sin(2 * np.pi * 300 * t)
                + 0.05 * np.random.default_rng(0).standard_normal(t.shape)) \
            .astype(np.float32)
    raise SystemExit('pass --wav or --synthetic')


def main(argv=None) -> int:
    args = parse_args(argv)
    from .runtime import resolve_device
    from .serving import StreamingTranscriber
    from .training.build import build_frontend, load_run

    dev = resolve_device(args.device)
    cfg, model, labels, _ = load_run(args.model_path)
    model.to(dev).eval()
    mcfg = cfg['model']
    sr = int(mcfg['audio_conf']['sample_rate'])
    sw = build_streamer(cfg, model,
                        build_frontend(mcfg, dither=0.0, device=dev),
                        len(labels), args.chunk_frames, args.int8, dev)
    hop_ms = float(mcfg['audio_conf']['window_stride']) * 1e3
    print(f'prime {sw.prime_samples / sr:.2f}s | chunk '
          f'{args.chunk_frames * hop_ms:.0f} ms | lookahead '
          f'{sw.lookahead_frames * hop_ms / 1e3:.2f}s', file=sys.stderr)
    audio = read_audio(args, sr)

    tr = StreamingTranscriber(sw.start(1), labels)
    chunk = sw.chunk_samples
    chunk_audio_ms = chunk / sr * 1e3
    lat = []
    for s in range(0, len(audio), chunk):
        piece = audio[None, s:s + chunk]
        t0 = time.perf_counter()
        fresh = tr.feed(piece)
        dt = (time.perf_counter() - t0) * 1e3
        if s >= sw.prime_samples:
            lat.append(dt)
        if fresh[0]:
            print(f'[{s / sr:6.2f}s +{dt:5.1f}ms] {fresh[0]!r}')
        if args.realtime:
            time.sleep(max(0.0, piece.shape[1] / sr - dt / 1e3))
    t0 = time.perf_counter()
    final = tr.finish(np.array([len(audio)]))
    fin_ms = (time.perf_counter() - t0) * 1e3
    print(f'final   (+{fin_ms:5.1f}ms): {final[0]!r}')
    frame_seconds = float(mcfg['audio_conf']['window_stride']) \
        * model.scaling_factor
    times = tr.word_timings(frame_seconds)[0]
    if times:
        print('timings : ' + ' '.join(f'{w}[{a:.2f}-{b:.2f}]'
                                      for w, a, b in times))
    if lat:
        print(f'steady-state chunk latency: median '
              f'{np.median(lat):.1f} ms / p95 '
              f'{np.percentile(lat, 95):.1f} ms for '
              f'{chunk_audio_ms:.0f} ms audio chunks '
              f'(RTF {np.median(lat) / chunk_audio_ms:.4f})',
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
