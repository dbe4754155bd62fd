"""Serving validation on trained weights: exact parity and explained WER.

    python -m wav2letter_pytorch_tpu_torch.validate_serving --epochs 30 \
        [--n-train 400] [--out DIR] [--json-out FILE] [--device cuda]

The counterpart of the JAX package's ``scripts/validate_serving.py``.
Trains the synthetic-corpus demo model (``train_synthetic_demo``) unless
``<out>/run`` already holds checkpoints, exports it twice
(``export_serving``: f32 with corpus CMVN; int8 with CMVN and calibrated
activation scales), then validates the serving layer at two levels:

1. **Log-prob parity** (direct APIs, the same utterances, the same CMVN
   normalisation): the live model's eval forward, the BN-folded
   ``offline_forward``, the f32 artifact's fold, and the streaming session
   under precomputed CMVN, within ``PARITY_TOL``. TF32 is off on the
   port's path (``runtime.resolve_device``), as the JAX script pins
   ``default_matmul_precision('highest')``.
2. **WER matrix with normalisation tags**: seven ``evaluate.main`` paths,
   each tagged with its input normalisation. Rows with the same tag (and
   the same streaming coverage) must agree within ``SAME_TAG_WER_TOL``;
   cross-tag deltas are a different model input and are recorded with the
   explanation.

Any parity or same-tag failure exits 1. Writes the report to
``--json-out`` (default ``<out>/serving_validation.json``) and prints it
as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

PARITY_TOL = {
    # live model vs BN-folded stack: fold rounding only
    'model_vs_folded': 2e-3,
    # folded live weights vs f32 artifact round-trip: npz is bit-exact
    'folded_vs_artifact': 1e-6,
    # streaming (precomputed CMVN) vs offline folded: carried f32 sums
    'streaming_vs_folded': 5e-3,
}
# Same-tag rows run the same math; a WER gap above this between two of
# them is a serving regression.
SAME_TAG_WER_TOL = 0.01


def _run_eval(argv) -> dict:
    from . import evaluate as eval_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_cli.main(argv)
    if rc != 0:
        raise SystemExit(f'evaluate failed ({rc}): {argv}')
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_parity(run_dir: str, art_f32: str, manifest: str, n_utts: int = 4,
               device='cuda'):
    """Level 1: the max |d log p| of each pair of ``PARITY_TOL`` over the
    first ``n_utts`` utterances of ``manifest`` longer than the streamer's
    prime window. Returns ``(result, ok)``."""
    from .data.dataset import ManifestDataset, resample_flag
    from .runtime import resolve_device
    from .serving import (StreamingWav2Letter, fold_batchnorm, load_serving,
                          offline_forward, stream_logprobs)
    from .serving.infer import to_device
    from .training.build import build_frontend, load_run

    dev = resolve_device(device)
    cfg, model, labels, _ = load_run(run_dir)
    model.to(dev).eval()
    mcfg = cfg['model']
    layers = [dict(l) for l in mcfg['layers']][:int(mcfg['mid_layers'])]
    pad_mode = str(mcfg.get('padding_mode', 'reflect'))
    folded_live = to_device(fold_batchnorm(model, len(layers)), dev)
    meta, folded_art, norm_stats = load_serving(art_f32)
    if norm_stats is None:
        raise SystemExit('the f32 artifact must carry CMVN stats')
    folded_art = to_device(folded_art, dev)
    fe_cmvn = build_frontend(mcfg, dither=0.0, device=dev,
                             norm_stats=norm_stats)
    sw = StreamingWav2Letter(layers, len(labels), model, fe_cmvn,
                             chunk_frames=32, norm='precomputed',
                             norm_stats=norm_stats, padding_mode=pad_mode,
                             device=dev)
    ac = mcfg['audio_conf']
    ds = ManifestDataset(manifest, int(ac['sample_rate']), labels,
                         resample=resample_flag(ac))
    hop = fe_cmvn.hop
    deltas = dict.fromkeys(PARITY_TOL, 0.0)
    used = 0
    for i in range(len(ds)):
        audio = np.asarray(ds[i][0], np.float32)[None, :]
        if audio.shape[1] <= sw.prime_samples:
            continue
        L = audio.shape[1]
        # The documented equivalence regime: offline on the audio
        # zero-padded beyond the network's lookahead (tail outputs read
        # that far ahead; streaming flushes zeros there), rounded to the
        # loader's framing (frame count = 0 mod 8) that the stream plan
        # derives its conv pads for.
        m = 8 * hop
        with_la = L + (sw.lookahead_frames + 16) * hop
        L_pad = ((max(with_la - 7 * hop, 0) + m - 1) // m) * m + 7 * hop
        buf = np.zeros((1, L_pad), np.float32)
        buf[0, :L] = audio[0]
        with torch.no_grad():
            feats, flens = fe_cmvn(torch.from_numpy(buf).to(dev),
                                   torch.tensor([L], dtype=torch.int32,
                                                device=dev))
            lp_model, out_lens = model(feats, flens)
            lp_fold, _ = offline_forward(layers, folded_live, feats, flens,
                                         padding_mode=pad_mode)
            lp_art, _ = offline_forward(layers, folded_art, feats, flens,
                                        padding_mode=pad_mode)
        lp_stream = stream_logprobs(sw, audio, length=L)
        v = min(int(out_lens[0]), lp_stream.shape[1])
        lp_model, lp_fold, lp_art = (x[:, :v].cpu().numpy()
                                     for x in (lp_model, lp_fold, lp_art))
        for name, a, b in (('model_vs_folded', lp_model, lp_fold),
                           ('folded_vs_artifact', lp_fold, lp_art),
                           ('streaming_vs_folded', lp_stream[:, :v],
                            lp_fold)):
            deltas[name] = max(deltas[name], float(np.abs(a - b).max()))
        used += 1
        if used >= n_utts:
            break
    result = {'utterances': used}
    failures = []
    for name, tol in PARITY_TOL.items():
        result[name] = {'max_abs_delta': deltas[name], 'tolerance': tol,
                        'ok': deltas[name] <= tol}
        if deltas[name] > tol:
            failures.append(f'{name}: {deltas[name]:.2e} > {tol:.0e}')
    if failures:
        print(f'PARITY FAILURE: {failures}', file=sys.stderr)
    return result, not failures


def same_tag_checks(results: dict, tags: dict) -> tuple:
    """Every pair of rows under one normalisation tag with the same
    streaming coverage: ``(checks, ok)``, a pair ok when its WER delta is
    within ``SAME_TAG_WER_TOL``."""
    ok, checks = True, []
    for tag, names in tags.items():
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = names[i], names[j]
                # Streaming skips sub-prime utterances; only rows over the
                # same utterances compare.
                if results[a].get('skipped_below_prime', 0) != \
                        results[b].get('skipped_below_prime', 0):
                    continue
                d = abs(results[a]['wer'] - results[b]['wer'])
                good = d <= SAME_TAG_WER_TOL
                ok &= good
                checks.append({'pair': [a, b], 'tag': tag,
                               'wer_delta': round(d, 4), 'ok': good})
    return checks, ok


def wer_paths(run_dir: str, art_f32: str, art_int8: str, val: str) -> dict:
    """name -> (``evaluate`` argv, normalisation tag) of the WER matrix."""
    return {
        'offline': (['--model-path', run_dir, '--test-manifest', val],
                    'per_utterance'),
        'streaming': (['--model-path', run_dir, '--test-manifest', val,
                       '--streaming', '--streaming-chunk-frames', '32'],
                      'cumulative'),
        # Same math as 'offline' through another runtime (MeshInference
        # over the artifact's fold, per-utterance norm): a same-tag pair
        # across the run-directory / artifact boundary.
        'artifact_offline_perutt': (['--artifact', art_f32,
                                     '--test-manifest', val, '--offline',
                                     '--offline-norm', 'per-utterance'],
                                    'per_utterance'),
        'artifact_offline_f32': (['--artifact', art_f32,
                                  '--test-manifest', val, '--offline',
                                  '--offline-norm', 'cmvn'],
                                 'cmvn'),
        'artifact_streaming_f32': (['--artifact', art_f32,
                                    '--test-manifest', val,
                                    '--streaming-chunk-frames', '32'],
                                   'cmvn'),
        'artifact_streaming_int8': (['--artifact', art_int8,
                                     '--test-manifest', val,
                                     '--streaming-chunk-frames', '32'],
                                    'cmvn_int8'),
        'artifact_int8_full': (['--artifact', art_int8,
                                '--test-manifest', val, '--offline',
                                '--offline-norm', 'cmvn', '--int8-full'],
                               'cmvn_int8_full'),
    }


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=30)
    parser.add_argument('--n-train', type=int, default=400)
    parser.add_argument('--out', default=os.path.join('runs',
                                                      'w2l_serv_val'))
    parser.add_argument('--json-out', default='',
                        help='report path (default: '
                             '<out>/serving_validation.json)')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import export_serving as export_cli
    from . import train_synthetic_demo as demo

    manifests = demo.make_corpus(os.path.join(args.out, 'data'),
                                 n_train=args.n_train)
    run_dir = os.path.join(args.out, 'run')
    if not os.path.isdir(os.path.join(run_dir, 'checkpoints')):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = demo.main(['--epochs', str(args.epochs),
                            '--n-train', str(args.n_train),
                            '--out', args.out, '--device', args.device])
        if rc != 0:
            raise SystemExit(f'train_synthetic_demo failed ({rc})')
        print(buf.getvalue().strip().splitlines()[-1], file=sys.stderr)

    val = manifests['val']
    art_f32 = os.path.join(args.out, 'artifact_f32')
    art_int8 = os.path.join(args.out, 'artifact_int8')
    for art, flags in ((art_f32, []), (art_int8, ['--int8', '--calibrate'])):
        rc = export_cli.main(['--model-path', run_dir, '--out', art,
                              '--cmvn-manifest', manifests['train'],
                              '--device', args.device] + flags)
        if rc != 0:
            raise SystemExit(f'export_serving failed ({rc})')

    parity, parity_ok = run_parity(run_dir, art_f32, val,
                                   device=args.device)

    results, tags = {}, {}
    for name, (argv_eval, tag) in wer_paths(run_dir, art_f32, art_int8,
                                            val).items():
        r = _run_eval(argv_eval + ['--device', args.device])
        results[name] = {'wer': round(r['wer'], 4),
                         'cer': round(r['cer'], 4), 'normalization': tag}
        if 'skipped_below_prime' in r:
            results[name]['skipped_below_prime'] = r['skipped_below_prime']
        tags.setdefault(tag, []).append(name)
    checks, wer_ok = same_tag_checks(results, tags)

    off = results['offline']['wer']
    cmvn_off = results['artifact_offline_f32']['wer']
    out = {
        'corpus': 'synthetic (train_synthetic_demo)',
        'epochs': args.epochs,
        'parity': parity,
        'paths': results,
        'same_tag_checks': checks,
        'cross_tag_explanations': {
            'offline_vs_cmvn': {
                'wer_delta': round(off - cmvn_off, 4),
                'explanation':
                    'offline normalizes each utterance with its own '
                    'full-utterance feature statistics; artifact paths '
                    'normalize with corpus CMVN stats — a different model '
                    'input, so a WER delta here is a normalization-mode '
                    'effect, not a serving regression (the same-tag checks '
                    'above pin the serving math itself). This is also the '
                    'root cause of any streaming-vs-offline WER anomaly: '
                    'streaming uses cumulative running stats, a third '
                    'normalization mode.'},
        },
        'ok': bool(parity_ok and wer_ok),
    }
    path = args.json_out or os.path.join(args.out, 'serving_validation.json')
    with open(path, 'w') as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0 if out['ok'] else 1


if __name__ == '__main__':
    raise SystemExit(main())
