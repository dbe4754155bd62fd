"""Offline batched evaluation (PyTorch, CUDA): the offline branch of the JAX
package's ``test.py``.

    python -m wav2letter_pytorch_tpu_torch.evaluate --test-manifest m.jsonl \
        [--model-path RUN [--average-last K] | --weights sd.pt] \
        [--lm-path lm.arpa] [--beam-search-params k=8,alpha=0.15,...] \
        [--beam-backend host|device] [--hotwords w1,w2 --hotword-weight W] \
        [--word-timings] [--print-samples | --print-all] \
        [--dump-jsonl f.jsonl] [--seed N] [--batch-size B] [--device cuda] \
        [--mid-layers N] [model=quartznet] [key=value ...]

Reads a CSV or JSON-lines manifest of WAV files, runs the log-mel frontend
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
the weights. Otherwise the model comes from the training config
(``config.py``, the same overrides as ``train.py``): Wav2Letter-20 by
default, ``model=quartznet`` or ``model=jasper`` for the Jasper family
(kernels K4 and K6), with ``--weights`` a ``state_dict`` saved with
``torch.save`` or a file holding ``{'state_dict': ...}`` (what the JAX
package's ``scripts/export_torch_checkpoint.py`` writes from a JAX run),
or weights drawn from ``--seed``. Batches are bucketed as ``test.py``
buckets them: ``--batch-size`` or the config's ``data.batch_size``, and
its ``data.num_length_buckets`` and ``data.max_duration``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .config import BASE, load_config
from .data.dataset import BucketBatchLoader, ManifestDataset
from .data.features import SpectrogramFrontend
from .decoding.beam_device import DeviceBeamDecoder
from .decoding.decoder import (GreedyDecoder, PrefixBeamSearchLMDecoder,
                               _beam_offsets, get_time_per_word,
                               parse_beam_params)
from .runtime import resolve_device
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
                max_duration: float | None = BASE['data']['max_duration']
                ) -> BucketBatchLoader:
    """Length-bucketed batches in manifest order; the defaults are the
    config's ``data`` block (4 buckets, 16.7 s)."""
    ds = ManifestDataset(manifest, frontend.conf.sample_rate, labels)
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
                c, cd = decoder.cer_ratio(expected, decoded[j])
                w, wd = decoder.wer_ratio(expected, decoded[j])
                acc.add('cer', c, cd)
                acc.add('wer', w, wd)
                dump.add(batch['paths'][j], expected, decoded[j], w, wd, c,
                         cd)
                if print_all or (print_samples and j == 0):
                    print(f'reference: {expected}')
                    print(f'decoded  : {decoded[j]}')
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
    parser.add_argument('overrides', nargs='*', metavar='key=value',
                        help='config overrides, e.g. model=quartznet')
    args = parser.parse_args(argv)
    if args.model_path and (args.weights or args.mid_layers is not None):
        parser.error('--weights and --mid-layers do not go with '
                     '--model-path (the run gives the model)')
    if args.average_last and not args.model_path:
        parser.error('--average-last needs --model-path')
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
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
    data = cfg['data']
    loader = make_loader(args.test_manifest,
                         args.batch_size or int(data['batch_size']), frontend,
                         labels, num_buckets=int(data['num_length_buckets']),
                         max_duration=data['max_duration'])
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
