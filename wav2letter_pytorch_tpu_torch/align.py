"""Forced alignment: word timestamps for manifests with known text.

    python -m wav2letter_pytorch_tpu_torch.align --artifact ART \
        --manifest data.jsonl [--out words.jsonl] \
        [--norm per-utterance|cmvn] [--device cuda | --cpu]

The counterpart of the JAX package's ``scripts/align.py``. Runs a
Wav2Letter serving artifact (any weight format) over the manifest in
batches of ``max(8, n)`` rounded up to the n devices of
``parallel.device_mesh`` (``serving.MeshInference``: kernel K1 and the
folded stack) and aligns each utterance's transcript to its log-probs by
CTC Viterbi (``decoding/forced_align.py::word_alignments``). Writes one
JSON record an utterance (``path``, ``text``, ``words`` as ``[word,
start_s, end_s]``, or ``error``) and prints the summary line
``{"num_utterances", "failed", "frame_seconds", "out"}``; exits 1 when an
utterance cannot be aligned.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='CTC forced alignment')
    parser.add_argument('--artifact', required=True)
    parser.add_argument('--manifest', required=True)
    parser.add_argument('--out', default='', help='JSONL output path')
    parser.add_argument('--norm', default='per-utterance',
                        choices=['per-utterance', 'cmvn'])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU (--device cpu)')
    args = parser.parse_args(argv)
    if args.cpu:
        args.device = 'cpu'


    from .data.dataset import (BucketBatchLoader, ManifestDataset,
                               resample_flag)
    from .decoding.forced_align import word_alignments
    from .parallel import device_mesh
    from .runtime import resolve_device
    from .serving import MeshInference, artifact_frontend, load_serving

    dev = resolve_device(args.device)
    meta, folded, norm_stats = load_serving(args.artifact)
    if meta.get('family', 'wav2letter') != 'wav2letter':
        raise SystemExit('align supports the wav2letter family')
    ac = meta['audio_conf']
    frontend = artifact_frontend(
        meta, norm_stats if args.norm == 'cmvn' else None, device=dev)
    mi = MeshInference(meta['layers'], folded, frontend,
                       mesh=device_mesh(args.device), mode=meta['format'],
                       padding_mode=meta.get('padding_mode', 'reflect'),
                       act_scales=meta.get('act_scales'))
    scale = 1
    for layer in meta['layers']:
        scale *= int(layer.get('stride', 1))
    frame_seconds = float(ac['window_stride']) * scale

    ds = ManifestDataset(args.manifest, int(ac['sample_rate']),
                         meta['labels'], resample=resample_flag(ac))
    n_dev = mi.mesh.size
    loader = BucketBatchLoader(ds, max(8, n_dev) + (-max(8, n_dev)) % n_dev,
                               frontend.hop, num_buckets=4, shuffle=False)
    records, n_failed = [], 0
    for batch in loader:
        logp, sizes = mi.logprobs(batch['audio'], batch['audio_lengths'])
        for j, text in enumerate(batch['texts']):
            if not batch['batch_mask'][j]:
                continue
            try:
                words = word_alignments(logp[j, :int(sizes[j])], text,
                                        meta['labels'],
                                        frame_seconds=frame_seconds)
            except ValueError as e:
                n_failed += 1
                records.append({'path': batch['paths'][j], 'text': text,
                                'error': str(e)})
                continue
            records.append({
                'path': batch['paths'][j], 'text': text,
                'words': [[w, round(s, 3), round(e, 3)]
                          for w, s, e in words]})
    if args.out:
        with open(args.out, 'w') as f:
            for r in records:
                f.write(json.dumps(r) + '\n')
    print(json.dumps({'num_utterances': len(records),
                      'failed': n_failed,
                      'frame_seconds': frame_seconds,
                      'out': args.out or None}))
    return 0 if n_failed == 0 else 1


if __name__ == '__main__':
    sys.exit(main())
