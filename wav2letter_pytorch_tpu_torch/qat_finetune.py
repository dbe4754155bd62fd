"""Quantization-aware finetune of a trained run for int8_full serving.

    python -m wav2letter_pytorch_tpu_torch.qat_finetune --model-path RUN \
        --from-artifact ART --train-manifest train.jsonl --out NEW_ART \
        [--steps 300] [--lr 1e-4] [--opt lamb|adam] [--batch-size 16] \
        [--eval-manifest test.jsonl] [--log-every 25] \
        [--norm per-utterance|cmvn] [--average-last K] \
        [--f32-layers 0,head] [--device cuda]

The counterpart of the JAX package's ``scripts/qat_finetune.py``, over the
port's run directories (``training/build.py::load_run``). Starts from the
run's f32 BN fold, finetunes it through the fake-quantized deployment
graph (``serving/qat.py``: kernel K1 in the frontend, K2 and K3 in the
CTC loss on the card) against the calibrated activation scales of
``--from-artifact`` (``export_serving --int8 --calibrate``), and writes a
new int8 artifact with the same CMVN statistics and scales. With
``--eval-manifest`` it reports int8_full greedy WER and CER before and
after (``MeshInference('int8_full')``). The last line of its output is
the report as one JSON object, with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import sys


def evaluate_int8(layers, folded_q, frontend, ds, labels, act_scales,
                  padding_mode: str, batch_size: int, device) -> dict:
    """int8_full greedy ``{'cer', 'wer'}`` of ``folded_q`` over ``ds``."""
    from .data.dataset import BucketBatchLoader
    from .decoding.decoder import GreedyDecoder
    from .serving import MeshInference
    from .training.metrics import RatioAccumulator

    decoder = GreedyDecoder(labels)
    mi = MeshInference(layers, folded_q, frontend, mode='int8_full',
                       padding_mode=padding_mode, act_scales=act_scales,
                       device=device)
    loader = BucketBatchLoader(ds, batch_size, frontend.hop, num_buckets=4,
                               shuffle=False)
    acc = RatioAccumulator()
    for batch in loader:
        logp, out_lens = mi.logprobs(batch['audio'], batch['audio_lengths'])
        decoded = decoder.decode(logp, sizes=out_lens)
        for j, text in enumerate(batch['texts']):
            if not batch['batch_mask'][j]:
                continue
            acc.add('cer', *decoder.cer_ratio(text, decoded[j]))
            acc.add('wer', *decoder.wer_ratio(text, decoded[j]))
    return acc.ratios()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='QAT finetune for int8')
    parser.add_argument('--model-path', required=True,
                        help="the port's training run directory "
                             '(config.json + checkpoints/)')
    parser.add_argument('--from-artifact', required=True,
                        help='calibrated artifact supplying act_scales + '
                             'CMVN (export_serving --int8 --calibrate)')
    parser.add_argument('--train-manifest', required=True)
    parser.add_argument('--out', required=True, help='new artifact dir')
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--opt', default='lamb', choices=['lamb', 'adam'],
                        help='lamb (trust-ratio; lr is per-step relative '
                             'drift — the safe default for folded weights '
                             'spanning orders of magnitude) or adam')
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--eval-manifest', default='',
                        help='report int8_full greedy WER before/after')
    parser.add_argument('--log-every', type=int, default=25,
                        help='loss log/history interval in steps')
    parser.add_argument('--norm', default='per-utterance',
                        choices=['per-utterance', 'cmvn'],
                        help='feature normalization to finetune (and eval) '
                             'against: per-utterance matches offline '
                             'artifact eval; cmvn (the artifact stats) '
                             'matches exact-parity streaming deployment')
    parser.add_argument('--average-last', type=int, default=None,
                        help='start from the average of the newest K '
                             'checkpoints (checkpoint averaging)')
    parser.add_argument('--f32-layers', default='',
                        help="comma list of layer indices and/or 'head' to "
                             'exempt from quantization (mixed precision)')
    parser.add_argument('--device', default='cuda',
                        help='device of the finetuning and the evaluations')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .data.dataset import (BucketBatchLoader, ManifestDataset,
                               resample_flag)
    from .runtime import resolve_device
    from .serving import (artifact_frontend, export_serving, fold_batchnorm,
                          load_serving, quantize_folded)
    from .serving import qat
    from .training.build import load_run

    f32_layers = tuple(s if s == 'head' else int(s)
                       for s in args.f32_layers.split(',') if s)
    dev = resolve_device(args.device)
    meta, _, norm_stats = load_serving(args.from_artifact)
    act_scales = meta.get('act_scales')
    if act_scales is None:
        raise SystemExit('--from-artifact has no act_scales; re-export '
                         'with --int8 --calibrate')

    cfg, model, labels, step = load_run(args.model_path,
                                        average_last=args.average_last)
    if str(cfg['model']['name']) != 'wav2letter':
        raise SystemExit('QAT export covers the wav2letter family')
    layers = meta['layers']
    folded = fold_batchnorm(model, len(layers))
    print(f'finetuning fold of step {step} ({len(folded)} layers)',
          file=sys.stderr)

    ac = meta['audio_conf']
    # Deployment features: no dither; per-utterance normalisation (the
    # offline artifact evaluation's default) or the artifact's CMVN (what
    # exact streaming consumes).
    if args.norm == 'cmvn' and norm_stats is None:
        raise SystemExit('--norm cmvn: artifact has no CMVN stats')
    frontend = artifact_frontend(
        meta, norm_stats if args.norm == 'cmvn' else None, device=dev)
    padding_mode = meta.get('padding_mode', 'reflect')

    def dataset(manifest):
        return ManifestDataset(manifest, int(ac['sample_rate']), labels,
                               resample=resample_flag(ac))
    loader = BucketBatchLoader(dataset(args.train_manifest), args.batch_size,
                               frontend.hop, num_buckets=4, shuffle=True)

    report = {'steps': args.steps, 'lr': args.lr, 'opt': args.opt,
              'norm': args.norm, 'batch_size': args.batch_size,
              'f32_layers': [str(x) for x in f32_layers]}
    eval_ds = None
    if args.eval_manifest:
        eval_ds = dataset(args.eval_manifest)
        report['before'] = evaluate_int8(
            layers, quantize_folded(folded), frontend, eval_ds, labels,
            act_scales, padding_mode, args.batch_size, dev)
        print(f"before: {report['before']}", file=sys.stderr)

    new_folded, history = qat.qat_finetune(
        layers, folded, frontend, loader, act_scales=act_scales,
        steps=args.steps, learning_rate=args.lr, optimizer=args.opt,
        f32_layers=f32_layers, padding_mode=padding_mode,
        log_every=args.log_every,
        progress=lambda m: print(m, file=sys.stderr))
    report['history'] = history

    if eval_ds is not None:
        report['after'] = evaluate_int8(
            layers, quantize_folded(new_folded), frontend, eval_ds, labels,
            act_scales, padding_mode, args.batch_size, dev)
        print(f"after: {report['after']}", file=sys.stderr)

    export_serving(
        args.out, layers, int(meta['num_labels']), None, labels=labels,
        audio_conf=ac, weights='int8', norm_stats=norm_stats,
        padding_mode=padding_mode,
        feature_type=meta.get('feature_type', 'logmel'),
        n_mels=int(meta['n_mels']), act_scales=act_scales,
        folded=new_folded)
    report['artifact'] = args.out
    print(json.dumps(report))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
