"""Full-depth end-to-end run: FLAC corpus -> train -> evaluate -> serving.

    python -m wav2letter_pytorch_tpu_torch.make_offline_corpus --root CORPUS
    python -m wav2letter_pytorch_tpu_torch.full_depth_run \
        --corpus-root CORPUS --run-dir RUN [--epochs 60] [--batch-size 16] \
        [--lr 2e-3] [--model wav2letter|jasper|quartznet] [--mid-layers N] \
        [--labels english_lowercase] [--skip-train] [--skip-extras] \
        [--resume-train] [--override key=value ...] [--out RESULT.json] \
        [--cpu]

The port's copy of the JAX package's ``scripts/full_depth_run.py``, with
the same recipe: the full model (Wav2Letter-20 by default), NovoGrad at
``--lr`` with gamma 0.985, SpecAugment (the ``data.augment`` map
override), ``data.cache_audio=true`` and ``data.audio_dtype=int16`` on
the corpus of ``make_offline_corpus``; then the same chain of ``evaluate``
calls: greedy on val and test, beam, beam with a 3-gram LM trained on the
train transcripts, streaming with cumulative and with corpus-CMVN
normalisation, and (unless ``--skip-extras``) bounded lookahead of 96
frames with both normalisations and an exported artifact (int8 weights,
calibrated, evaluated ``--offline --int8-full`` for Wav2Letter on the
card; f32 on the CPU or for the Jasper family).

Two departures: the JAX recipe's ``trainer.steps_per_dispatch=4`` (a TPU
dispatch knob that leaves the math unchanged) is dropped, and training
runs in this process in one go (the JAX script's segments under a host
memory budget guard a TPU client that keeps every uploaded buffer).
Each stage's result is written to ``--out`` (default
``<run-dir>/full_depth_run.json``) as soon as it is known; the last line
of the standard output is the whole record.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time


def run_evaluate(args_list):
    """``evaluate.main`` on ``args_list``: its JSON result line."""
    from . import evaluate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(args_list)
    if rc != 0:
        raise RuntimeError(f'evaluate failed: {args_list}')
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def recipe_overrides(args, manifests) -> list:
    """The training overrides of the recipe, then ``--override``'s."""
    return [
        f'data.train_manifest={manifests["train"]}',
        f'data.val_manifest={manifests["val"]}',
        f'data.batch_size={args.batch_size}',
        'data.num_length_buckets=3',
        'data.cache_audio=true',
        'data.audio_dtype=int16',
        f'model={args.model}',
        'optimizer=novograd', f'model.optimizer.lr={args.lr}',
        'model.scheduler.gamma=0.985',
        f'model.mid_layers={args.mid_layers}',
        f'model.labels={args.labels}',
        'data.augment={spec_augment: {freq_masks: 2, time_masks: 2, '
        'freq_width: 10, time_width: 20}}',
        f'trainer.max_epochs={args.epochs}',
        'trainer.string_metrics_interval=50',
        'trainer.log_every_n_steps=50',
        'trainer.val_every_n_epochs=5',
        'trainer.checkpoint.every_n_epochs=5',
        f'trainer.default_root_dir={args.run_dir}',
    ] + list(args.override)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--corpus-root', required=True)
    parser.add_argument('--run-dir', required=True)
    parser.add_argument('--epochs', type=int, default=60)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--lr', type=float, default=2e-3)
    parser.add_argument('--model', choices=['wav2letter', 'jasper',
                                            'quartznet'],
                        default='wav2letter',
                        help='model config group (jasper/quartznet run '
                             'the same pipeline on the separable family)')
    parser.add_argument('--mid-layers', type=int, default=None,
                        help='defaults to the full stack: 20 (wav2letter), '
                             '15 (jasper), 18 (quartznet)')
    parser.add_argument('--labels', default='english_lowercase',
                        help='label set (e.g. hebrew for a --lang hebrew '
                             'corpus)')
    parser.add_argument('--skip-train', action='store_true')
    parser.add_argument('--skip-extras', action='store_true',
                        help='skip the bounded-lookahead evals and the '
                             'artifact export and eval')
    parser.add_argument('--resume-train', action='store_true',
                        help='continue an interrupted run in --run-dir')
    parser.add_argument('--override', action='append', default=[],
                        help='extra train-time config override(s), e.g. '
                             'trainer.log_every_n_steps=1 (repeatable)')
    parser.add_argument('--out', default='',
                        help='result JSON (default '
                             '<run-dir>/full_depth_run.json)')
    parser.add_argument('--cpu', action='store_true',
                        help='the whole pipeline on the CPU (default: the '
                             'GPU)')
    args = parser.parse_args(argv)
    args.device = 'cpu' if args.cpu else 'cuda'
    if args.mid_layers is None:
        args.mid_layers = {'wav2letter': 20, 'jasper': 15,
                           'quartznet': 18}[args.model]
    args.out = args.out or os.path.join(args.run_dir, 'full_depth_run.json')
    return args


def main(argv=None) -> int:
    from . import export_serving, train
    from .data.dataset import read_manifest
    from .decoding.ngram_train import train_arpa

    args = parse_args(argv)
    root = args.corpus_root
    manifests = {s: os.path.join(root, f'{s}_manifest.csv')
                 for s in ('train', 'val', 'test')}
    dev = ['--device', args.device]
    results = {
        'pipeline': 'make_offline_corpus (FLAC) -> train -> evaluate '
                    '-> serving artifact',
        'model': f'{args.model} mid_layers={args.mid_layers}',
        'labels': args.labels,
        'optimizer': f'novograd lr={args.lr}', 'augment': 'spec_augment',
        'epochs': args.epochs, 'batch_size': args.batch_size,
        'device': args.device,
    }
    if args.override:
        key = ('extra_overrides_ignored_skip_train' if args.skip_train
               else 'extra_overrides')
        results[key] = list(args.override)

    def save():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        tmp = args.out + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(results, f, indent=2)
        os.replace(tmp, args.out)

    if not args.skip_train:
        t0 = time.time()
        train.main(recipe_overrides(args, manifests) + dev
                   + (['--resume'] if args.resume_train else []))
        results['train_wall_seconds'] = round(time.time() - t0, 1)
    save()

    run = ['--model-path', args.run_dir] + dev
    test = ['--test-manifest', manifests['test']]
    for split in ('val', 'test'):
        results[f'{split}_greedy'] = run_evaluate(
            run + ['--test-manifest', manifests[split]])
        save()
    results['test_beam'] = run_evaluate(
        run + test + ['--beam-search-params', 'k=16,prune=0.0001'])
    save()

    lm_path = os.path.join(args.run_dir, 'corpus_lm.arpa')
    train_arpa([r['text'] for r in read_manifest(manifests['train'])],
               lm_path, order=3)
    results['test_beam_lm'] = run_evaluate(
        run + test + ['--lm-path', lm_path, '--beam-search-params',
                      'k=16,alpha=0.15,beta=0,prune=0.0001'])
    save()

    stream = ['--streaming', '--streaming-chunk-frames', '64']
    cmvn = ['--streaming-norm', 'cmvn', '--streaming-cmvn-manifest',
            manifests['train']]
    results['test_streaming'] = run_evaluate(run + test + stream)
    save()
    results['test_streaming_cmvn'] = run_evaluate(run + test + stream + cmvn)
    save()

    if args.skip_extras:
        print(json.dumps(results))
        return 0

    la = ['--lookahead-frames', '96']
    results['test_streaming_la96'] = run_evaluate(run + test + stream + la)
    save()
    results['test_streaming_la96_cmvn'] = run_evaluate(
        run + test + stream + la + cmvn)
    save()

    artifact = os.path.join(args.run_dir, 'artifact')
    int8_ok = args.model == 'wav2letter'
    with contextlib.redirect_stdout(io.StringIO()):
        export_serving.main(
            ['--model-path', args.run_dir, '--out', artifact,
             '--cmvn-manifest', manifests['train'], '--cmvn-limit', '1000']
            + (['--int8', '--calibrate'] if int8_ok else []) + dev)
    art = ['--artifact', artifact] + test + ['--offline'] + dev
    if args.device == 'cpu' or not int8_ok:
        results['test_artifact_offline'] = run_evaluate(art)
    else:
        results['test_artifact_offline_int8full'] = run_evaluate(
            art + ['--int8-full'])
    save()
    print(json.dumps(results))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
