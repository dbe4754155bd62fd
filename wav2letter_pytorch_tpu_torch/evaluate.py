"""Offline batched evaluation (PyTorch, CUDA): the offline branch of the JAX
package's ``test.py``.

    python -m wav2letter_pytorch_tpu_torch.evaluate --test-manifest m.jsonl \
        [--model-path RUN [--average-last K] | --weights sd.pt] \
        [--lm-path lm.arpa] [--beam-search-params k=8,alpha=0.15,...] \
        [--beam-backend host|device] [--hotwords w1,w2 --hotword-weight W] \
        [--word-timings] [--print-samples | --print-all] \
        [--dump-jsonl f.jsonl] [--seed N] [--batch-size B] \
        [--device cuda | --cpu] \
        [--mid-layers N] [model=quartznet] [key=value ...]

Reads a CSV or JSON-lines manifest of WAV or FLAC files (resampled to the
model's rate where ``model.audio_conf.resample`` is set, as ``test.py``
reads them), runs the log-mel (or MFCC) frontend
(kernel K1), the model, the masked CTC mean (kernel K2) on the device, and
decodes: greedily from argmax ids taken on the device; or, with
``--lm-path``, ``--beam-search-params`` or ``--hotwords``, by prefix beam
search, on the host (``--beam-backend host``: the C++ search of
``csrc/host/`` per utterance) or batched on the device (``device``: the
eval step's log-probabilities as they come out of the step). Prints one
JSON line ``{"loss", "num_utterances", "cer", "wer"}`` as ``test.py``
does, with ``--print-samples`` / ``--print-all`` its (reference, decoded)
pairs, with ``--word-timings`` its ``timings  :`` lines and with
``--dump-jsonl`` one record per utterance.

The model: ``--model-path`` is a run directory of the port's trainer; its
``config.json`` (after ``key=value`` overrides) builds the model and its
newest checkpoint (or the average of the newest ``--average-last`` K) gives
the weights; a run trained with tensor parallelism (``trainer.mesh.model``
> 1 in its config) evaluates in one process, as its checkpoints hold the
whole tensors. Otherwise the model comes from the training config
(``config.py``, the same overrides as ``train.py``): Wav2Letter-20 by
default, ``model=quartznet`` or ``model=jasper`` for the Jasper family
(kernels K4 and K6), with ``--weights`` a ``state_dict`` saved with
``torch.save`` or a file holding ``{'state_dict': ...}`` (what the JAX
package's ``scripts/export_torch_checkpoint.py`` writes from a JAX run),
or weights drawn from ``--seed``. Batches are bucketed as ``test.py``
buckets them: ``--batch-size`` or the config's ``data.batch_size``, and
its ``data.num_length_buckets`` and ``data.max_duration``.

A serving artifact (``export_serving``'s, or the JAX package's
``scripts/export_serving.py``'s) is evaluated with ``--artifact DIR
--offline``, as ``test.py`` evaluates one: batched inference of the folded
stack (``serving.MeshInference``: kernel K1 and the folded convs, f32 or
int8 weights, or with ``--int8-full`` int8 activations on the int8 tensor
cores) over every visible GPU (``parallel.device_mesh``; the batch is
``max(8, n)`` rounded up to the n devices, ``mesh_devices`` in the
result), normalised per utterance or with the artifact's CMVN
(``--offline-norm cmvn``), decoded greedily or, with the artifact's bundled
LM (unless ``--no-lm``), an LM, beam parameters or hotwords, by the host
beam search. Without ``--offline`` an artifact is evaluated through the
streaming path (``serving.streaming_from_artifact``), one session an
utterance, greedily, skipping utterances no longer than the prime window.

Streaming, as ``test.py --streaming``: ``--model-path`` (or a model from
the config) runs through ``serving.StreamingWav2Letter`` or, for Jasper
and QuartzNet, ``serving.StreamingJasper`` (kernel K1 on every prime, step
and finish, K4 on every depthwise conv of Jasper's; f32 or ``--int8``
weights, cumulative or corpus-CMVN normalisation by ``--streaming-norm``),
utterances shorter than the prime window through the eval forward; with
``--lookahead-frames`` through ``serving.BoundedLookaheadStreamer`` (the
model over a window a chunk). ``--artifact`` without ``--offline``
streams either family's artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .config import BASE, load_config
from .data.dataset import BucketBatchLoader, ManifestDataset, resample_flag
from .data.features import SpectrogramFrontend
from .decoding.beam_device import DeviceBeamDecoder
from .decoding.decoder import (GreedyDecoder, PrefixBeamSearchLMDecoder,
                               _beam_offsets, get_time_per_word,
                               parse_beam_params)
from .parallel import device_mesh
from .runtime import resolve_device
from .serving import (MeshInference, artifact_frontend, compute_cmvn,
                      load_serving, quantize_folded, streaming_from_artifact)
from .serving.lookahead import (BoundedLookaheadStreamer,
                                _conv_specs_jasper, _conv_specs_w2l,
                                bounded_stream_logprobs)
from .serving.streaming import StreamingWav2Letter, stream_logprobs
from .serving.streaming_jasper import StreamingJasper
from .training.build import (build_frontend, build_labels, build_model,
                             load_run)
from .training.metrics import RatioAccumulator
from .training.trainer import eval_step, masked_ctc_mean, to_device

__all__ = ['build', 'evaluate', 'eval_step', 'main', 'make_loader',
           'masked_ctc_mean', 'to_device']

LABELS = 'english_lowercase'


def make_loader(manifest: str, batch_size: int, frontend: SpectrogramFrontend,
                labels=LABELS, prefetch: int = 2,
                num_buckets: int = BASE['data']['num_length_buckets'],
                max_duration: float | None = BASE['data']['max_duration'],
                resample: bool = False) -> BucketBatchLoader:
    """Length-bucketed batches in manifest order; the defaults are the
    config's ``data`` block (4 buckets, 16.7 s). ``resample`` converts
    files at another rate to the frontend's."""
    ds = ManifestDataset(manifest, frontend.conf.sample_rate, labels,
                         resample=resample)
    return BucketBatchLoader(ds, batch_size, frontend.hop,
                             num_buckets=num_buckets,
                             max_duration=max_duration, prefetch=prefetch)


def eval_config(overrides=(), mid_layers: int | None = None) -> dict:
    """The training config after ``overrides``, manifests left unset.
    ``mid_layers`` sets the depth; without it, and without a
    ``model.mid_layers`` override, Wav2Letter runs all 20 layers and the
    Jasper family its config's depth."""
    overrides = list(overrides)
    cfg = load_config(['data.train_manifest=-', 'data.val_manifest=-',
                       *overrides])
    mcfg = cfg['model']
    if mid_layers is not None:
        mcfg['mid_layers'] = int(mid_layers)
    elif mcfg['name'] == 'wav2letter' and not any(
            o.lstrip('+').startswith('model.mid_layers=') for o in overrides):
        mcfg['mid_layers'] = len(mcfg['layers'])
    return cfg


def load_weights(path: str) -> dict:
    """A ``state_dict`` file, or a file holding ``{'state_dict': ...}``
    (e.g. ``scripts/export_torch_checkpoint.py``'s output)."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get('state_dict'), dict):
        obj = obj['state_dict']
    return obj


def build(device: str | torch.device = 'cuda', seed: int = 0,
          weights: str | None = None, mid_layers: int | None = None,
          overrides=(), cfg: dict | None = None):
    """(model, frontend, labels) on ``device``, in eval mode, from ``cfg``,
    or from ``eval_config(overrides, mid_layers)`` without it. Raises if a
    CUDA device is asked for and none is present."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = eval_config(overrides, mid_layers)
    mcfg = cfg['model']
    labels = build_labels(mcfg)
    model = build_model(mcfg, len(labels), seed=seed)
    if weights:
        model.load_state_dict(load_weights(weights), strict=True)
    model.to(dev).eval()
    frontend = build_frontend(mcfg, dither=0.0, device=dev)
    return model, frontend, labels


class UttDump:
    """Per-utterance JSON-lines records (``--dump-jsonl``), as ``test.py``
    writes them."""

    def __init__(self, path: str):
        self._f = open(path, 'w') if path else None

    def add(self, path, ref, hyp, w, wd, c, cd):
        if self._f is None:
            return
        self._f.write(json.dumps({
            'path': path, 'ref': ref, 'hyp': hyp,
            'wer_edits': int(w), 'ref_words': int(wd),
            'cer_edits': int(c), 'ref_chars': int(cd)}) + '\n')

    def close(self):
        if self._f is not None:
            self._f.close()


def decode_batch(decoder, out: torch.Tensor, out_lens: torch.Tensor,
                 emits_probs: bool, offsets: bool):
    """(strings, per-char offsets or None) of one batch. ``out`` is the
    eval step's output: argmax ids for the greedy decoder, the model's
    output for a beam decoder (log-probabilities, or probabilities when
    ``emits_probs``)."""
    sizes = out_lens.cpu().numpy()
    if isinstance(decoder, GreedyDecoder):
        return decoder.decode_ids(out.cpu().numpy(), sizes,
                                  return_offsets=True)
    if isinstance(decoder, DeviceBeamDecoder):
        # One batched search on the step's device, on its log-probs.
        log_probs = torch.log(torch.clamp(out, min=1e-30)) if emits_probs \
            else out
        decoded = decoder.decode_log_probs(log_probs, out_lens)
        if not offsets:
            return decoded, None
        probs = out.cpu().numpy()
        if not emits_probs:
            probs = np.exp(probs)
        return decoded, [_beam_offsets(probs[j, :sizes[j]], decoded[j],
                                       decoder.labels, decoder.blank_index)
                         for j in range(len(decoded))]
    # Host beam search: probability space (test.py takes exp of
    # Wav2Letter's log-probs; Jasper's eval output is probabilities).
    probs = out.cpu().numpy()
    if not emits_probs:
        probs = np.exp(probs)
    if offsets:
        return decoder.decode(probs, sizes, return_offsets=True)
    return [decoder.decode(probs[j][:sizes[j]])
            for j in range(probs.shape[0])], None


def score_utterance(decoder, acc: RatioAccumulator, dump: UttDump,
                    path: str, expected: str, decoded: str,
                    print_pair: bool) -> None:
    """Add one utterance's edit counts to ``acc`` and ``dump``; print its
    (reference, decoded) pair when asked, as ``test.py`` does."""
    c, cd = decoder.cer_ratio(expected, decoded)
    w, wd = decoder.wer_ratio(expected, decoded)
    acc.add('cer', c, cd)
    acc.add('wer', w, wd)
    dump.add(path, expected, decoded, w, wd, c, cd)
    if print_pair:
        print(f'reference: {expected}')
        print(f'decoded  : {decoded}')


def evaluate(model: torch.nn.Module, frontend: SpectrogramFrontend,
             loader: BucketBatchLoader, decoder, device: str | torch.device,
             word_timings: bool = False, print_samples: bool = False,
             print_all: bool = False, dump_jsonl: str = '',
             frame_seconds: float | None = None) -> dict:
    """Loss, WER and CER over every batch of ``loader``, decoding with
    ``decoder`` (greedy, host beam or device beam); prints the (reference,
    decoded) pairs and word timings asked for, as ``test.py`` does.
    ``frame_seconds``: seconds an output frame (window stride x the
    model's stride), for the word timings."""
    dev = resolve_device(device)
    model.eval()
    emits_probs = bool(getattr(model, 'eval_emits_probs', False))
    output = 'ids' if isinstance(decoder, GreedyDecoder) else 'model'
    acc = RatioAccumulator()
    dump = UttDump(dump_jsonl)
    losses = []
    try:
        for batch in loader:
            loss, out, out_lens = eval_step(model, frontend,
                                            to_device(batch, dev), output)
            losses.append(float(loss))
            decoded, offsets = decode_batch(decoder, out, out_lens,
                                            emits_probs, word_timings)
            for j, expected in enumerate(batch['texts']):
                if not batch['batch_mask'][j]:
                    continue
                score_utterance(decoder, acc, dump, batch['paths'][j],
                                expected, decoded[j],
                                print_all or (print_samples and j == 0))
                if word_timings and offsets is not None:
                    times = get_time_per_word(list(decoded[j]),
                                              offsets[j].tolist(),
                                              ratio=frame_seconds)
                    print('timings  : ' + ' '.join(
                        f'{w}[{s0:.2f}-{e0:.2f}]' for w, s0, e0 in times))
    finally:
        dump.close()
    result = {'loss': float(np.mean(losses)) if losses else None,
              'num_utterances': len(loader.dataset)}
    result.update(acc.ratios())
    return result


def make_decoder(labels, args, device):
    """test.py's decoder choice: a beam decoder when an LM, beam
    parameters or hotwords are given (on the host or the device), else
    greedy."""
    beam_params = parse_beam_params(args.beam_search_params)
    hotwords = [w for w in args.hotwords.split(',') if w.strip()] or None
    if not (args.lm_path or beam_params or hotwords):
        return GreedyDecoder(labels)
    if args.beam_backend == 'device':
        return DeviceBeamDecoder(labels, lm_path=args.lm_path,
                                 hotwords=hotwords,
                                 hotword_weight=args.hotword_weight,
                                 device=device, **beam_params)
    return PrefixBeamSearchLMDecoder(args.lm_path, labels, hotwords=hotwords,
                                     hotword_weight=args.hotword_weight,
                                     **beam_params)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Offline evaluation (PyTorch)')
    parser.add_argument('--test-manifest', required=True)
    parser.add_argument('--model-path', default='',
                        help="the port's training run directory "
                             '(config.json + checkpoints/)')
    parser.add_argument('--average-last', type=int, default=None,
                        help='average the weights of the newest K '
                             'checkpoints (--model-path only)')
    parser.add_argument('--weights', default='',
                        help="state_dict saved with torch.save, or a "
                             "file holding {'state_dict': ...}; default: "
                             'weights drawn from --seed')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch-size', type=int, default=None,
                        help="default: the config's data.batch_size")
    parser.add_argument('--mid-layers', type=int, default=None,
                        help="blocks before the head (the config's "
                             'model.mid_layers; default: 20 for '
                             "Wav2Letter, the config's own for Jasper; "
                             'not with --model-path)')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU (--device cpu)')
    parser.add_argument('--print-samples', action='store_true',
                        help='print a (reference, decoded) pair per batch')
    parser.add_argument('--print-all', action='store_true',
                        help='print every (reference, decoded) pair')
    parser.add_argument('--lm-path', default='',
                        help='ARPA LM for prefix beam search')
    parser.add_argument('--word-timings', action='store_true',
                        help='print (word, start_s, end_s) per utterance '
                             '(greedy offsets, or forced-alignment offsets '
                             'under beam decoding)')
    parser.add_argument('--beam-search-params', default='',
                        help='e.g. k=16,alpha=0.5,beta=5,prune=1e-3 '
                             '(implies beam search even without --lm-path)')
    parser.add_argument('--beam-backend', default='host',
                        choices=['host', 'device'],
                        help="'host': the C++ search per utterance; "
                             "'device': the batched search on the eval "
                             "step's device (same exact in-loop LM and "
                             'hotword fusion)')
    parser.add_argument('--hotwords', default='',
                        help='comma-separated words/phrases to bias toward '
                             '(implies beam decoding)')
    parser.add_argument('--hotword-weight', type=float, default=2.0,
                        help='per-matched-character mass multiplier for '
                             '--hotwords')
    parser.add_argument('--dump-jsonl', default='',
                        help='write one JSON record per utterance '
                             '(path/ref/hyp/edit counts)')
    parser.add_argument('--artifact', default='',
                        help='serving artifact directory (export_serving); '
                             'evaluated with --offline')
    parser.add_argument('--offline', action='store_true',
                        help='artifact mode: batched offline inference of '
                             'the folded stack (serving.MeshInference)')
    parser.add_argument('--offline-norm', default='per-utterance',
                        choices=['per-utterance', 'cmvn'],
                        help='feature normalization for --artifact '
                             '--offline: per-utterance (as in training) or '
                             "the artifact's CMVN stats")
    parser.add_argument('--int8-full', action='store_true',
                        help='with --artifact --offline: int8 activations '
                             'too (int8 tensor cores), the weights quantized '
                             'if the artifact is f32')
    parser.add_argument('--no-lm', action='store_true',
                        help='greedy decode even if the artifact bundles '
                             'an LM')
    parser.add_argument('--streaming', action='store_true',
                        help='evaluate through the chunked streaming serving '
                             'path (serving/streaming.py), one session per '
                             'utterance; utterances shorter than the prime '
                             'window fall back to the eval forward')
    parser.add_argument('--streaming-chunk-frames', type=int, default=64,
                        help='streaming chunk size in STFT frames (64 = '
                             '640 ms at the default 10 ms hop)')
    parser.add_argument('--streaming-norm', default='cumulative',
                        choices=['cumulative', 'cmvn', 'precomputed'],
                        help='feature normalization for --streaming: '
                             'cumulative (running masked stats) or corpus '
                             'CMVN over --streaming-cmvn-manifest (cmvn, '
                             'or its synonym precomputed)')
    parser.add_argument('--streaming-cmvn-manifest', default='',
                        help='manifest to compute corpus CMVN over for '
                             '--streaming-norm cmvn (use the TRAIN '
                             'manifest)')
    parser.add_argument('--streaming-cmvn-limit', type=int, default=1000,
                        help='max utterances for the CMVN pass')
    parser.add_argument('--int8', action='store_true',
                        help='weight-only int8 quantized inference '
                             '(streaming mode only)')
    parser.add_argument('--lookahead-frames', type=int, default=0,
                        help='with --streaming: bounded-lookahead mode '
                             '(serving/lookahead.py), committing outputs '
                             'after this many frames of future context')
    parser.add_argument('--lookahead-extrap-frames', type=int, default=0,
                        help='with --lookahead-frames: extend each window '
                             'with this many synthesized future frames')
    parser.add_argument('--lookahead-extrap-mode', default='reflect',
                        choices=['reflect', 'repeat'])
    parser.add_argument('--lookahead-left-frames', type=int, default=None,
                        help='with --lookahead-frames: past context per '
                             'window (default: the full one-sided '
                             'receptive field)')
    parser.add_argument('overrides', nargs='*', metavar='key=value',
                        help='config overrides, e.g. model=quartznet')
    args = parser.parse_args(argv)
    if args.cpu:
        args.device = 'cpu'
    if args.model_path and (args.weights or args.mid_layers is not None):
        parser.error('--weights and --mid-layers do not go with '
                     '--model-path (the run gives the model)')
    if args.average_last and not (args.model_path or args.artifact):
        parser.error('--average-last needs --model-path')
    return args


def artifact_decoder(args, meta: dict):
    """``test.py``'s decoder for an artifact: the prefix beam search when an
    LM (``--lm-path``, or with ``--offline`` the artifact's bundled one
    unless ``--no-lm``), beam parameters or hotwords are given, else
    greedy."""
    labels = meta['labels']
    beam_params = parse_beam_params(args.beam_search_params)
    lm_path = args.lm_path
    if args.offline and not lm_path and meta.get('lm') and not args.no_lm:
        lm_path = os.path.join(args.artifact, meta['lm']['file'])
        beam_params = dict(meta['lm'].get('beam_params') or {},
                           **beam_params)
    hotwords = [w for w in args.hotwords.split(',') if w.strip()] or None
    if lm_path or beam_params or hotwords:
        return PrefixBeamSearchLMDecoder(
            lm_path, labels, hotwords=hotwords,
            hotword_weight=args.hotword_weight, **beam_params)
    return GreedyDecoder(labels)


def run_artifact_eval(args) -> int:
    """``test.py``'s ``--artifact`` evaluation (its flag checks, then
    ``run_artifact_offline_eval`` or its streaming loop): with
    ``--offline`` batched inference of the folded stack over the manifest,
    else one streaming session an utterance; prints its JSON line."""
    rejected = [(args.word_timings, '--word-timings'),
                (args.int8, '--int8'),
                (args.average_last, '--average-last'),
                (args.model_path, '--model-path'),
                (args.weights, '--weights'),
                (args.mid_layers is not None, '--mid-layers'),
                (args.overrides, 'key=value overrides')]
    if not args.offline:
        rejected += [(args.lm_path, '--lm-path'),
                     (args.beam_search_params, '--beam-search-params'),
                     (args.hotwords, '--hotwords')]
    for flag, name in rejected:
        if flag:
            raise SystemExit(f'{name} is not supported with --artifact '
                             '(the artifact fixes weights; streaming '
                             'decoding is greedy — use --offline for '
                             'beam/LM or --model-path eval)')
    if args.beam_backend == 'device':
        raise SystemExit('--beam-backend device is not supported with '
                         '--artifact (artifact evaluation beam-decodes on '
                         'the host, as test.py does)')
    dev = resolve_device(args.device)
    meta, folded, norm_stats = load_serving(args.artifact)
    if not args.offline:
        return run_artifact_streaming_eval(args, meta, dev)
    if meta.get('family', 'wav2letter') != 'wav2letter':
        raise SystemExit('--offline artifact eval supports wav2letter')
    use_cmvn = args.offline_norm == 'cmvn'
    if use_cmvn and norm_stats is None:
        raise SystemExit('--offline-norm cmvn: artifact has no CMVN stats')
    try:
        frontend = artifact_frontend(meta, norm_stats if use_cmvn else None,
                                     device=dev)
    except ValueError as e:
        raise SystemExit(str(e))
    decoder = artifact_decoder(args, meta)
    mode = meta['format']
    if args.int8_full:
        if meta['format'] != 'int8':
            folded = quantize_folded(folded)
        mode = 'int8_full'
    mi = MeshInference(meta['layers'], folded, frontend,
                       mesh=device_mesh(args.device), mode=mode,
                       padding_mode=meta.get('padding_mode', 'reflect'),
                       act_scales=meta.get('act_scales'))
    n_dev = mi.mesh.size
    bs = args.batch_size or max(8, n_dev)
    bs += (-bs) % n_dev
    ds = ManifestDataset(args.test_manifest, frontend.conf.sample_rate,
                         meta['labels'],
                         resample=resample_flag(meta['audio_conf']))
    loader = BucketBatchLoader(ds, bs, frontend.hop, num_buckets=4)
    acc = RatioAccumulator()
    dump = UttDump(args.dump_jsonl)
    is_beam = isinstance(decoder, PrefixBeamSearchLMDecoder)
    try:
        for batch in loader:
            logp, out_lens = mi.logprobs(batch['audio'],
                                         batch['audio_lengths'])
            if is_beam:
                # The beam search takes probabilities.
                probs = np.exp(logp)
                decoded = [decoder.decode(probs[j][:int(out_lens[j])])
                           for j in range(probs.shape[0])]
            else:
                decoded = decoder.decode(logp, sizes=out_lens)
            for j, text in enumerate(batch['texts']):
                if batch['batch_mask'][j]:
                    score_utterance(decoder, acc, dump, batch['paths'][j],
                                    text, decoded[j], args.print_all or (
                                        args.print_samples and j == 0))
    finally:
        dump.close()
    result = {'loss': None, 'num_utterances': len(ds), 'offline': True,
              'artifact': args.artifact, 'weights': mode,
              'decode': 'beam_lm' if is_beam else 'greedy',
              'normalization': args.offline_norm, 'mesh_devices': n_dev}
    result.update(acc.ratios())
    print(json.dumps(result))
    return 0


def run_artifact_streaming_eval(args, meta: dict, dev) -> int:
    """``test.py --artifact`` without ``--offline``: each utterance longer
    than the prime window through a fresh streaming session of the
    artifact (its weights and CMVN), decoded greedily; prints the JSON
    line with ``num_in_manifest`` and ``skipped_below_prime``."""
    try:
        sw, labels, _ = streaming_from_artifact(
            args.artifact, chunk_frames=args.streaming_chunk_frames,
            device=dev)
    except ValueError as e:
        raise SystemExit(str(e))
    decoder = GreedyDecoder(labels)
    ds = ManifestDataset(args.test_manifest, sw.sample_rate, labels,
                         resample=resample_flag(meta['audio_conf']))
    acc = RatioAccumulator()
    dump = UttDump(args.dump_jsonl)
    n_skipped = 0
    try:
        for i in range(len(ds)):
            audio, _, path, text = ds[i]
            audio = np.asarray(audio, np.float32)[None, :]
            if audio.shape[1] <= sw.prime_samples:
                n_skipped += 1
                continue
            decoded = decoder.decode(stream_logprobs(sw, audio))[0]
            score_utterance(decoder, acc, dump, path, text, decoded,
                            args.print_all or (args.print_samples
                                               and i == 0))
    finally:
        dump.close()
    # num_utterances = utterances the WER/CER cover (those shorter than
    # the prime window are skipped, not silently included).
    result = {'loss': None, 'num_utterances': len(ds) - n_skipped,
              'num_in_manifest': len(ds), 'streaming': True,
              'artifact': args.artifact, 'weights': meta['format'],
              'skipped_below_prime': n_skipped}
    result.update(acc.ratios())
    print(json.dumps(result))
    return 0


def streaming_norm_kwargs(args, cfg, labels, dev) -> dict:
    """norm/norm_stats of the streamers per ``--streaming-norm``:
    cumulative (no side data), or corpus CMVN over
    ``--streaming-cmvn-manifest`` (the train manifest), as a deployed
    artifact ships it."""
    if args.streaming_norm == 'cumulative':
        return {}
    if not args.streaming_cmvn_manifest:
        raise SystemExit('--streaming-norm cmvn requires '
                         '--streaming-cmvn-manifest (the train manifest)')
    mcfg = cfg['model']
    stats = compute_cmvn(
        args.streaming_cmvn_manifest,
        lambda normalize: build_frontend(mcfg, dither=0.0, device=dev,
                                         normalize=normalize),
        labels, mcfg['audio_conf'], limit=args.streaming_cmvn_limit)
    print(f'streaming CMVN over {args.streaming_cmvn_manifest}: '
          f'mean[0]={stats[0][0]:.3f} std[0]={stats[1][0]:.3f}',
          file=sys.stderr)
    return dict(norm='precomputed', norm_stats=stats)


def _eval_forward_padded(model, frontend, audio: np.ndarray, dev):
    """The eval forward of one utterance zero-padded to the 0.5 s grid:
    its output ``[1, T', L]`` over the valid frames (numpy; Wav2Letter's
    log-probs, Jasper's probabilities)."""
    L = audio.shape[1]
    grid = max(frontend.conf.sample_rate // 2, 1)
    buf = np.zeros((1, -(-L // grid) * grid), np.float32)
    buf[0, :L] = audio[0]
    with torch.no_grad():
        feats, flens = frontend(torch.from_numpy(buf).to(dev),
                                torch.tensor([L], dtype=torch.int32,
                                             device=dev))
        logp, out_lens = model(feats, flens)
    return logp[:, :int(out_lens[0])].cpu().numpy()


def run_streaming_eval(args, cfg, model, frontend, decoder, labels,
                       dev) -> int:
    """``test.py --streaming``: each utterance through a fresh
    ``StreamingWav2Letter`` or ``StreamingJasper`` session (or, no longer
    than the prime window, the eval forward at the 0.5 s-grid length),
    decoded by ``decoder`` (Jasper's probabilities, Wav2Letter's
    log-probabilities); prints the JSON line."""
    mcfg = cfg['model']
    emits_probs = mcfg['name'] == 'jasper'
    mid = int(mcfg['mid_layers'])
    kw = dict(chunk_frames=args.streaming_chunk_frames,
              weights='int8' if args.int8 else 'f32', device=dev,
              **streaming_norm_kwargs(args, cfg, labels, dev))
    frontend_s = build_frontend(mcfg, dither=0.0, device=dev)
    if emits_probs:
        sw = StreamingJasper([dict(b) for b in mcfg['jasper_blocks']][:mid],
                             len(labels), model, frontend_s, **kw)
    else:
        sw = StreamingWav2Letter(
            [dict(l) for l in mcfg['layers']][:mid], len(labels), model,
            frontend_s, padding_mode=mcfg.get('padding_mode', 'reflect'),
            **kw)
    sr = sw.sample_rate
    hop_ms = float(mcfg['audio_conf']['window_stride']) * 1e3
    print(f'streaming: prime {sw.prime_samples / sr:.2f}s, chunk '
          f'{args.streaming_chunk_frames * hop_ms:.0f} ms, lookahead '
          f'{sw.lookahead_frames * hop_ms / 1e3:.2f}s', file=sys.stderr)
    frame_seconds = (float(mcfg['audio_conf']['window_stride'])
                     * model.scaling_factor)
    ds = ManifestDataset(args.test_manifest, sr, labels,
                         resample=resample_flag(mcfg['audio_conf']))
    acc = RatioAccumulator()
    dump = UttDump(args.dump_jsonl)
    n_fallback = 0
    try:
        for i in range(len(ds)):
            audio, _, upath, text = ds[i]
            audio = np.asarray(audio, np.float32)[None, :]
            if audio.shape[1] <= sw.prime_samples:
                n_fallback += 1
                logp = _eval_forward_padded(model, frontend, audio, dev)
            else:
                logp = stream_logprobs(sw, audio)
            timed = args.word_timings
            probs = logp if emits_probs else np.exp(logp)
            if isinstance(decoder, DeviceBeamDecoder):
                out = decoder.decode(probs, np.array([logp.shape[1]]),
                                     return_offsets=timed)
                decoded, offsets0 = (out[0][0], out[1][0]) if timed \
                    else (out[0], None)
            elif isinstance(decoder, PrefixBeamSearchLMDecoder):
                out = decoder.decode(probs[0], return_offsets=timed)
                decoded, offsets0 = out if timed else (out, None)
            else:
                decoded, offsets = decoder.decode(logp, return_offsets=True)
                decoded, offsets0 = decoded[0], offsets[0]
            if args.word_timings and offsets0 is not None:
                times = get_time_per_word(list(decoded), offsets0.tolist(),
                                          ratio=frame_seconds)
                print('timings  : ' + ' '.join(
                    f'{w0}[{s0:.2f}-{e0:.2f}]' for w0, s0, e0 in times))
            score_utterance(decoder, acc, dump, upath, text, decoded,
                            args.print_all or (args.print_samples
                                               and i == 0))
    finally:
        dump.close()
    result = {'loss': None, 'num_utterances': len(ds), 'streaming': True,
              'normalization': args.streaming_norm,
              'offline_fallback': n_fallback,
              'weights': 'int8' if args.int8 else 'f32'}
    result.update(acc.ratios())
    print(json.dumps(result))
    return 0


def run_bounded_streaming_eval(args, cfg, model, decoder, labels,
                               dev) -> int:
    """``test.py --streaming --lookahead-frames``: each utterance through
    a ``BoundedLookaheadStreamer`` session that commits outputs after
    ``--lookahead-frames`` of future context (Wav2Letter log-probs, or
    Jasper probabilities scored as their log); prints the JSON line."""
    mcfg = cfg['model']
    emits_probs = mcfg['name'] == 'jasper'
    mid = int(mcfg['mid_layers'])
    if emits_probs:
        specs = _conv_specs_jasper(
            [dict(b) for b in mcfg['jasper_blocks']][:mid])
    else:
        specs = _conv_specs_w2l([dict(l) for l in mcfg['layers']][:mid])
    scale = int(model.scaling_factor)
    la = -(-int(args.lookahead_frames) // scale) * scale
    left = args.lookahead_left_frames
    if left is not None:
        left = -(-int(left) // scale) * scale
    sw = BoundedLookaheadStreamer(
        model, build_frontend(mcfg, dither=0.0, device=dev), specs,
        chunk_frames=args.streaming_chunk_frames, lookahead_frames=la,
        left_frames=left, extrap_frames=args.lookahead_extrap_frames,
        extrap_mode=args.lookahead_extrap_mode, device=dev,
        **streaming_norm_kwargs(args, cfg, labels, dev))
    hop_s = float(mcfg['audio_conf']['window_stride'])
    print(f'bounded-lookahead streaming: lookahead {la * hop_s:.2f}s, '
          f'chunk {args.streaming_chunk_frames * hop_s:.2f}s, window '
          f'{sw.window_frames} frames '
          f'({sw.window_frames / args.streaming_chunk_frames:.1f}x offline '
          'compute)', file=sys.stderr)
    ds = ManifestDataset(args.test_manifest, sw.sample_rate, labels,
                         resample=resample_flag(mcfg['audio_conf']))
    acc = RatioAccumulator()
    dump = UttDump(args.dump_jsonl)
    try:
        for i in range(len(ds)):
            audio, _, upath, text = ds[i]
            audio = np.asarray(audio, np.float32)[None, :]
            out = bounded_stream_logprobs(sw, audio)
            logp = np.log(np.maximum(out, 1e-30)) if emits_probs else out
            score_utterance(decoder, acc, dump, upath, text,
                            decoder.decode(logp)[0],
                            args.print_all or (args.print_samples
                                               and i == 0))
    finally:
        dump.close()
    result = {'loss': None, 'num_utterances': len(ds), 'streaming': True,
              'normalization': args.streaming_norm,
              'bounded_lookahead_frames': la,
              'bounded_lookahead_seconds': round(la * hop_s, 3),
              'left_frames': sw.left_frames,
              'window_frames': sw.window_frames}
    if args.lookahead_extrap_frames:
        result['extrap_frames'] = sw.extrap_frames
        result['extrap_mode'] = sw.extrap_mode
    result.update(acc.ratios())
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.offline and not args.artifact:
        raise SystemExit('--offline is an artifact-eval mode; pass '
                         '--artifact <dir>')
    if args.int8_full and not (args.artifact and args.offline):
        raise SystemExit('--int8-full applies to --artifact --offline '
                         'evaluation only')
    if (args.lookahead_frames or args.int8) and not (args.streaming
                                                     or args.artifact):
        raise SystemExit('--lookahead-frames and --int8 apply to '
                         '--streaming evaluation only')
    if args.artifact:
        return run_artifact_eval(args)
    dev = resolve_device(args.device)
    if args.model_path:
        cfg, model, labels, step = load_run(
            args.model_path, args.overrides, args.average_last,
            seed=args.seed)
        if step is None:
            print('WARNING: no checkpoint found; evaluating random init',
                  file=sys.stderr)
        elif args.average_last and args.average_last > 1:
            print(f'Averaged last {args.average_last} checkpoints '
                  f'(through step {step})', file=sys.stderr)
        else:
            print(f'Loaded checkpoint at step {step}', file=sys.stderr)
        model.to(dev).eval()
        frontend = build_frontend(cfg['model'], dither=0.0, device=dev)
    else:
        cfg = eval_config(args.overrides, args.mid_layers)
        model, frontend, labels = build(dev, args.seed, args.weights,
                                        cfg=cfg)
    decoder = make_decoder(labels, args, dev)
    if args.streaming and args.lookahead_frames:
        return run_bounded_streaming_eval(args, cfg, model, decoder, labels,
                                          dev)
    if args.streaming:
        return run_streaming_eval(args, cfg, model, frontend, decoder,
                                  labels, dev)
    data = cfg['data']
    loader = make_loader(args.test_manifest,
                         args.batch_size or int(data['batch_size']), frontend,
                         labels, num_buckets=int(data['num_length_buckets']),
                         max_duration=data['max_duration'],
                         resample=resample_flag(cfg['model']['audio_conf']))
    frame_seconds = (float(cfg['model']['audio_conf']['window_stride'])
                     * model.scaling_factor)
    result = evaluate(model, frontend, loader, decoder, dev,
                      word_timings=args.word_timings,
                      print_samples=args.print_samples,
                      print_all=args.print_all, dump_jsonl=args.dump_jsonl,
                      frame_seconds=frame_seconds)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
