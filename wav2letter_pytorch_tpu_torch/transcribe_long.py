"""Transcribe a long recording through exact chunked long-form inference.

    python -m wav2letter_pytorch_tpu_torch.transcribe_long --artifact DIR \
        --audio long.wav [--int8-full] [--norm per-utterance|cmvn] \
        [--chunk-frames 2000] [--max-batch 8] [--verify-oneshot] \
        [--lm-path lm.arpa --beam-search-params k=..] [--no-lm] \
        [--hotwords w1,w2] [--word-timings] [--json-out r.json] \
        [--mesh] [--device cuda]
    python -m wav2letter_pytorch_tpu_torch.transcribe_long --artifact DIR \
        --concat-manifest test.csv --minutes 10

The counterpart of the JAX package's ``scripts/transcribe_long.py``, over
``serving.LongFormTranscriber`` on ``--device`` (with ``--mesh``, the
windows spread over every visible GPU, ``parallel.device_mesh``). With
``--concat-manifest`` the input is the manifest's utterances concatenated
up to ``--minutes``, and since their transcripts are known the result
also holds the WER and CER. ``--verify-oneshot`` also runs the one-shot
offline stack on the same audio and reports its largest log-prob
difference from the chunked one. Prints one JSON line (and the transcript
when no reference is known).

``--audio`` reads WAV or FLAC (other containers with soundfile) and
resamples a file at another rate to the artifact's, as the JAX script
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='exact long-form transcription from a serving artifact')
    parser.add_argument('--artifact', required=True)
    parser.add_argument('--audio', default='',
                        help='audio file to transcribe (WAV, FLAC; '
                             'resampled to the artifact\'s rate)')
    parser.add_argument('--concat-manifest', default='',
                        help="build the long input by concatenating this "
                             "manifest's utterances (reports WER too)")
    parser.add_argument('--minutes', type=float, default=10.0,
                        help='target length for --concat-manifest')
    parser.add_argument('--int8-full', action='store_true',
                        help='int8 activations too (needs the artifact\'s '
                             'act_scales)')
    parser.add_argument('--norm', default='per-utterance',
                        choices=['per-utterance', 'cmvn'])
    parser.add_argument('--chunk-frames', type=int, default=2000,
                        help='core output frames per window (memory knob)')
    parser.add_argument('--max-batch', type=int, default=8,
                        help='windows per call')
    parser.add_argument('--mesh', action='store_true',
                        help='shard windows across all local devices')
    parser.add_argument('--verify-oneshot', action='store_true',
                        help='cross-check against the one-shot offline run')
    parser.add_argument('--lm-path', default='',
                        help='ARPA LM: decode with LM-fused prefix beam '
                             'search instead of greedy')
    parser.add_argument('--beam-search-params', default='',
                        help='k=,alpha=,beta=,prune= for --lm-path')
    parser.add_argument('--no-lm', action='store_true',
                        help='greedy decode even if the artifact bundles '
                             'an LM')
    parser.add_argument('--hotwords', default='',
                        help='comma-separated words/phrases to bias toward '
                             'inside the beam search (implies beam '
                             'decoding)')
    parser.add_argument('--hotword-weight', type=float, default=2.0)
    parser.add_argument('--word-timings', action='store_true',
                        help='print (word, start_s, end_s) lines to stderr '
                             'and include them in --json-out (greedy '
                             'offsets)')
    parser.add_argument('--json-out', default='',
                        help='write the result record to this file')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def read_input(args, meta, sample_rate: int):
    """(audio, reference transcript | None) from ``--audio`` or
    ``--concat-manifest``."""
    from .data.audio_io import read_audio
    from .data.dataset import ManifestDataset, resample_flag
    from .data.resample import resample
    if args.concat_manifest:
        ds = ManifestDataset(
            args.concat_manifest, sample_rate, meta['labels'],
            resample=resample_flag(meta['audio_conf']))
        target = int(args.minutes * 60 * sample_rate)
        pieces, texts, total = [], [], 0
        for i in range(len(ds)):
            audio_i, _, _, text = ds[i]
            pieces.append(np.asarray(audio_i, np.float32))
            texts.append(text)
            total += len(pieces[-1])
            if total >= target:
                break
        return np.concatenate(pieces), ' '.join(texts)
    if not args.audio:
        raise SystemExit('need --audio or --concat-manifest')
    audio, sr = read_audio(args.audio)
    if sr != sample_rate:
        print(f'resampling {sr} Hz -> artifact rate {sample_rate} Hz',
              file=sys.stderr)
        audio = resample(audio, sr, sample_rate)
    return np.asarray(audio, np.float32), None


def main(argv=None) -> int:
    args = parse_args(argv)
    from .decoding.decoder import (GreedyDecoder, PrefixBeamSearchLMDecoder,
                                   get_time_per_word, parse_beam_params)
    from .parallel import device_mesh
    from .runtime import resolve_device
    from .serving import LongFormTranscriber, artifact_frontend, load_serving
    from .serving.longform import decode_segmented

    mesh = device_mesh(args.device) if args.mesh else None
    dev = resolve_device(args.device if mesh is None else mesh.devices[0])
    meta, folded, norm_stats = load_serving(args.artifact)
    if meta.get('family', 'wav2letter') != 'wav2letter':
        raise SystemExit('long-form supports the wav2letter family; use '
                         'streaming for Jasper (evaluate --artifact, '
                         'serve_tcp, stream_demo)')
    if args.norm == 'cmvn' and norm_stats is None:
        raise SystemExit('--norm cmvn: artifact has no CMVN stats')
    try:
        frontend = artifact_frontend(
            meta, norm_stats if args.norm == 'cmvn' else None, device=dev)
    except ValueError as e:
        raise SystemExit(str(e))
    sample_rate = frontend.conf.sample_rate
    decoder = GreedyDecoder(meta['labels'])
    audio, reference_text = read_input(args, meta, sample_rate)

    mode = 'int8_full' if args.int8_full else (
        'int8' if meta['format'] == 'int8' else 'f32')
    act_scales = meta.get('act_scales')
    if mode == 'int8_full' and not act_scales:
        raise SystemExit('--int8-full: artifact has no act_scales')
    padding_mode = meta.get('padding_mode', 'reflect')
    lf = LongFormTranscriber(
        meta['layers'], folded, frontend, decoder, mode=mode,
        padding_mode=padding_mode,
        act_scales=act_scales if mode == 'int8_full' else None,
        chunk_frames=args.chunk_frames, max_batch=args.max_batch,
        mesh=mesh, device=dev)

    secs = len(audio) / sample_rate
    print(f'input: {secs / 60:.1f} min ({len(audio)} samples), mode={mode}, '
          f'chunk_frames={args.chunk_frames}', file=sys.stderr)
    # The first run warms up (cuDNN plans, the allocator); the second is
    # timed. logprobs() returns on the host, after the device is done.
    logp, valid = lf.logprobs(audio)
    t0 = time.perf_counter()
    logp, valid = lf.logprobs(audio)
    dt = time.perf_counter() - t0

    lm_path = args.lm_path
    beam_params = None
    if not lm_path and meta.get('lm') and not args.no_lm:
        lm_path = os.path.join(args.artifact, meta['lm']['file'])
        beam_params = dict(meta['lm'].get('beam_params') or {})
    hotwords = [w for w in args.hotwords.split(',') if w.strip()] or None
    if lm_path or args.beam_search_params or hotwords:
        beam_params = dict(beam_params or {},
                           **parse_beam_params(args.beam_search_params))
        beam = PrefixBeamSearchLMDecoder(lm_path, meta['labels'],
                                         hotwords=hotwords,
                                         hotword_weight=args.hotword_weight,
                                         **beam_params)
        t1 = time.perf_counter()
        # Beam-decoded per silence-bounded segment: the probability-space
        # DP underflows past a few thousand frames.
        text = decode_segmented(logp[:valid], beam)
        dt_decode = time.perf_counter() - t1
    else:
        text = decoder.decode(logp[None, :valid, :],
                              sizes=np.array([valid]))[0]
        dt_decode = None

    word_times = None
    if args.word_timings:
        g_text, g_offsets = decoder.decode(logp[None, :valid, :],
                                           sizes=np.array([valid]),
                                           return_offsets=True)
        # seconds an output frame = window stride x the stack's stride
        scale = 1
        for l in meta['layers']:
            scale *= int(l.get('stride', 1))
        ratio = float(meta['audio_conf']['window_stride']) * scale
        word_times = [(w, round(float(a), 2), round(float(b), 2))
                      for w, a, b in get_time_per_word(
                          list(g_text[0]), list(g_offsets[0]), ratio)]
        for w, a, b in word_times[:20]:
            print(f'{a:9.2f} {b:9.2f}  {w}', file=sys.stderr)
        if len(word_times) > 20:
            print(f'... {len(word_times) - 20} more words', file=sys.stderr)

    result = {
        'artifact': args.artifact, 'mode': mode, 'norm': args.norm,
        'audio_seconds': round(secs, 2),
        'chunk_frames': args.chunk_frames, 'max_batch': args.max_batch,
        'wall_seconds': round(dt, 3),
        'x_realtime': round(secs / dt, 1),
        'transcript_chars': len(text),
        'device': str(dev),
    }
    if dt_decode is not None:
        result['decode'] = 'beam_lm'
        result['beam_seconds'] = round(dt_decode, 3)
    if word_times is not None:
        result['num_words_timed'] = len(word_times)
    if reference_text is not None:
        w, wd = decoder.wer_ratio(reference_text, text)
        c, cd = decoder.cer_ratio(reference_text, text)
        result['wer'] = w / max(wd, 1)
        result['cer'] = c / max(cd, 1)
    if args.verify_oneshot:
        import torch
        with torch.no_grad():
            feats, flens = frontend(
                torch.from_numpy(audio[None, :]).to(dev),
                torch.tensor([len(audio)], dtype=torch.int32, device=dev))
            feats = feats[:, :int(flens[0])]
            ref, _ = lf.fwd(lf.weights, feats)
        ref = ref[0].cpu().numpy()
        result['oneshot_max_abs_diff'] = float(np.max(np.abs(ref - logp)))
        result['oneshot_argmax_equal'] = bool(
            (ref.argmax(-1) == logp.argmax(-1)).all())
    print(json.dumps(result))
    if args.json_out:
        if word_times is not None:   # the full list only in the file
            result['word_timings'] = word_times
        with open(args.json_out, 'w') as f:
            json.dump(result, f, indent=1)
    if reference_text is None:
        print(text)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
