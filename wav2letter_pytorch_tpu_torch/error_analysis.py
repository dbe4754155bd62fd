"""Error analysis over a per-utterance eval dump.

    python -m wav2letter_pytorch_tpu_torch.evaluate --model-path RUN \
        --test-manifest test.jsonl --dump-jsonl utts.jsonl
    python -m wav2letter_pytorch_tpu_torch.error_analysis utts.jsonl \
        [--worst 10] [--top 15] [--json-out report.json]

The counterpart of the JAX package's ``scripts/error_analysis.py``. Reads
the JSONL records ``evaluate --dump-jsonl`` writes (any path: a run
directory, artifact streaming, artifact offline) and reports the worst
utterances by WER and the corpus's word-level error modes (substitution
pairs, deletions, insertions) from minimum-edit alignments
(``decoding/levenshtein.py::align``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='eval-dump error analysis')
    parser.add_argument('dump', help='JSONL from evaluate --dump-jsonl')
    parser.add_argument('--worst', type=int, default=10,
                        help='worst-N utterances to print')
    parser.add_argument('--top', type=int, default=15,
                        help='top-N error modes per class')
    parser.add_argument('--json-out', default='',
                        help='write the full report as JSON')
    args = parser.parse_args(argv)

    from .decoding.levenshtein import align

    utts = []
    with open(args.dump) as f:
        for line in f:
            if line.strip():
                utts.append(json.loads(line))
    if not utts:
        raise SystemExit(f'{args.dump}: no records')

    subs = collections.Counter()
    dels = collections.Counter()
    inss = collections.Counter()
    n_ok = n_sub = n_del = n_ins = 0
    for u in utts:
        u['wer'] = u['wer_edits'] / max(u['ref_words'], 1)
        for op, r, h in align(u['ref'].split(), u['hyp'].split()):
            if op == 'ok':
                n_ok += 1
            elif op == 'sub':
                n_sub += 1
                subs[(r, h)] += 1
            elif op == 'del':
                n_del += 1
                dels[r] += 1
            else:
                n_ins += 1
                inss[h] += 1

    total_ref = n_ok + n_sub + n_del
    total_err = n_sub + n_del + n_ins
    print(f'{len(utts)} utterances, {total_ref} reference words')
    print(f'errors: {total_err} ({total_err / max(total_ref, 1):.2%} WER) = '
          f'{n_sub} sub + {n_del} del + {n_ins} ins')
    print(f'\nworst {args.worst} utterances:')
    worst = sorted(utts, key=lambda u: -u['wer'])[:args.worst]
    for u in worst:
        print(f"  {u['wer']:6.2%}  {os.path.basename(u['path'])}")
        print(f"      ref: {u['ref']}")
        print(f"      hyp: {u['hyp']}")
    if subs:
        print('\ntop substitutions (ref -> hyp):')
        for (r, h), c in subs.most_common(args.top):
            print(f'  {c:4d}  {r} -> {h}')
    if dels:
        print('\ntop deletions:')
        for w, c in dels.most_common(args.top):
            print(f'  {c:4d}  {w}')
    if inss:
        print('\ntop insertions:')
        for w, c in inss.most_common(args.top):
            print(f'  {c:4d}  {w}')

    if args.json_out:
        with open(args.json_out, 'w') as f:
            json.dump({
                'num_utterances': len(utts),
                'ref_words': total_ref,
                'wer': total_err / max(total_ref, 1),
                'substitutions': n_sub, 'deletions': n_del,
                'insertions': n_ins,
                'top_substitutions': [
                    {'ref': r, 'hyp': h, 'count': c}
                    for (r, h), c in subs.most_common(args.top)],
                'top_deletions': [{'word': w, 'count': c}
                                  for w, c in dels.most_common(args.top)],
                'top_insertions': [{'word': w, 'count': c}
                                   for w, c in inss.most_common(args.top)],
                'worst_utterances': [
                    {'path': u['path'], 'wer': u['wer'], 'ref': u['ref'],
                     'hyp': u['hyp']} for u in worst],
            }, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
