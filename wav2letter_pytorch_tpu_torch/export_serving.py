"""Export a training run of the port as a self-contained serving artifact.

    python -m wav2letter_pytorch_tpu_torch.export_serving --model-path RUN \
        --out DIR [--int8] [--cmvn-manifest train.csv [--cmvn-limit N]] \
        [--calibrate [--calibrate-clips N]] [--average-last K] \
        [--lm-path lm.arpa [--lm-beam-params k=16,alpha=0.15,...]] \
        [--device cuda | --cpu]

The counterpart of the JAX package's ``scripts/export_serving.py``, over
the port's run directories (``training/build.py::load_run``). The artifact
(``serving.npz`` + ``serving.json``, the JAX package's format) holds the
BN-folded weights (f32, or int8 with ``--int8``), the layer geometry,
labels and audio config; with ``--cmvn-manifest`` corpus CMVN statistics;
with ``--calibrate`` static int8 activation scales for int8_full
inference; with ``--lm-path`` the ARPA LM and its decode settings.
CMVN and calibration run the frontend (kernel K1) and the folded stack on
``--device``. A Jasper / QuartzNet run is exported as the JAX script
exports one (``serving.export_serving_jasper``: the ``fold_jasper``
descriptors, stored f32 and quantized at load, so ``--int8`` and
``--calibrate`` are refused).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Export serving artifact')
    parser.add_argument('--model-path', required=True,
                        help="the port's training run directory "
                             '(config.json + checkpoints/)')
    parser.add_argument('--out', required=True, help='artifact directory')
    parser.add_argument('--int8', action='store_true',
                        help='per-channel int8 weight-only quantization')
    parser.add_argument('--cmvn-manifest', default='',
                        help='manifest to measure corpus CMVN stats on')
    parser.add_argument('--cmvn-limit', type=int, default=None,
                        help='cap utterances used for CMVN')
    parser.add_argument('--calibrate', action='store_true',
                        help='with --int8 + --cmvn-manifest: record static '
                             'int8 activation scales for int8_full '
                             'inference')
    parser.add_argument('--calibrate-clips', type=int, default=8,
                        help='utterances used for activation calibration')
    parser.add_argument('--average-last', type=int, default=None,
                        help="average the newest K checkpoints' weights "
                             'before export')
    parser.add_argument('--lm-path', default='',
                        help='ARPA LM to bundle into the artifact; artifact '
                             'evaluations then beam-decode with it')
    parser.add_argument('--lm-beam-params', default='',
                        help='k=,alpha=,beta=,prune= recorded with the '
                             'bundled LM as its decode settings')
    parser.add_argument('--device', default='cuda',
                        help='device of the CMVN and calibration passes')
    parser.add_argument('--cpu', action='store_true',
                        help='run those passes on the CPU (--device cpu)')
    args = parser.parse_args(argv)
    if args.cpu:
        args.device = 'cpu'
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from .data.dataset import ManifestDataset, resample_flag
    from .decoding.decoder import parse_beam_params
    from .runtime import resolve_device
    from .serving import (calibrate_activation_scales, compute_cmvn,
                          export_serving, export_serving_jasper,
                          fold_batchnorm)
    from .training.build import build_frontend, load_run, run_config

    dev = resolve_device(args.device)
    family = run_config(args.model_path)['model']['name']
    if family not in ('wav2letter', 'jasper'):
        raise SystemExit(f'unknown model family {family!r}')
    if family == 'jasper' and (args.int8 or args.calibrate):
        raise SystemExit('jasper artifacts are stored f32 — quantize '
                         'at load (StreamingJasper weights="int8"); '
                         '--int8/--calibrate apply to wav2letter only')
    if args.calibrate and not (args.int8 and args.cmvn_manifest):
        raise SystemExit('--calibrate needs --int8 and --cmvn-manifest')
    cfg, model, labels, step = load_run(args.model_path,
                                        average_last=args.average_last)
    mcfg = cfg['model']
    print(f'exporting step {step}', file=sys.stderr)

    norm_stats = None
    if args.cmvn_manifest:
        norm_stats = compute_cmvn(
            args.cmvn_manifest,
            lambda normalize: build_frontend(mcfg, dither=0.0, device=dev,
                                             normalize=normalize),
            labels, mcfg['audio_conf'], limit=args.cmvn_limit)
        print(f'CMVN over {args.cmvn_manifest}: mean[0]='
              f'{norm_stats[0][0]:.3f} std[0]={norm_stats[1][0]:.3f}',
              file=sys.stderr)

    if family == 'jasper':
        blocks = [dict(b) for b in
                  mcfg['jasper_blocks']][:int(mcfg['mid_layers'])]
        export_serving_jasper(args.out, blocks, len(labels), model,
                              labels=labels,
                              audio_conf=dict(mcfg['audio_conf']),
                              norm_stats=norm_stats,
                              feature_type=mcfg.get('feature_type',
                                                    'logmel'),
                              n_mels=int(mcfg['input_size']))
        print(f'wrote {args.out}/serving.npz + serving.json',
              file=sys.stderr)
        return 0

    layers = [dict(l) for l in mcfg['layers']][:int(mcfg['mid_layers'])]
    folded = fold_batchnorm(model, len(layers))
    act_scales = None
    if args.calibrate:
        ds = ManifestDataset(
            args.cmvn_manifest, int(mcfg['audio_conf']['sample_rate']),
            labels, resample=resample_flag(mcfg['audio_conf']))
        n = min(args.calibrate_clips, len(ds))
        clips = [np.asarray(ds[i][0], np.float32) for i in range(n)]
        audio = np.zeros((n, max(len(c) for c in clips)), np.float32)
        for i, c in enumerate(clips):
            audio[i, :len(c)] = c
        cal_fe = build_frontend(mcfg, dither=0.0, device=dev,
                                norm_stats=norm_stats)
        act_scales = calibrate_activation_scales(
            layers, folded, cal_fe, audio,
            np.array([len(c) for c in clips]),
            padding_mode=mcfg.get('padding_mode', 'reflect'))
        print(f'calibrated {len(act_scales)} activation scales '
              f'(first {act_scales[0]:.4f})', file=sys.stderr)

    export_serving(args.out, layers, len(labels), model, labels=labels,
                   audio_conf=dict(mcfg['audio_conf']),
                   weights='int8' if args.int8 else 'f32',
                   norm_stats=norm_stats,
                   padding_mode=mcfg.get('padding_mode', 'reflect'),
                   feature_type=mcfg.get('feature_type', 'logmel'),
                   n_mels=int(mcfg['input_size']), act_scales=act_scales,
                   folded=folded, lm_path=args.lm_path,
                   lm_beam_params=parse_beam_params(args.lm_beam_params))
    print(f'wrote {args.out}/serving.npz + serving.json', file=sys.stderr)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
