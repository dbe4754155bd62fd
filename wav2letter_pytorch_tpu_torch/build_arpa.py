"""Train an ARPA n-gram LM from manifest transcripts (or plain text).

    python -m wav2letter_pytorch_tpu_torch.build_arpa --manifest train.csv \
        --out lm.arpa [--order 3] [--prune-count 0]
    python -m wav2letter_pytorch_tpu_torch.build_arpa --text corpus.txt \
        --order 4 --out lm.arpa

The counterpart of the JAX package's ``scripts/build_arpa.py``: an
interpolated Kneser-Ney model (``decoding/ngram_train.py``) written as an
ARPA file that every LM consumer of the port reads (``evaluate
--lm-path``, ``export_serving --lm-path``, the host and device beam
searches), then reloaded through ``PyArpaLM`` to print its train-set
perplexity in one JSON line. A CSV manifest is read in pandas' layout (a
leading index column) with ``csv``, an empty transcript as pandas reads
it (``nan``).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys


def read_sentences(manifest: str = '', text: str = '') -> list[str]:
    if text:
        with open(text, encoding='utf-8') as f:
            return [ln.strip() for ln in f if ln.strip()]
    if manifest.endswith('.csv'):
        with open(manifest, newline='', encoding='utf-8') as f:
            reader = csv.reader(f)
            col = next(reader).index('text')
            return [r[col] or 'nan' for r in reader if r]
    with open(manifest, encoding='utf-8') as f:
        return [json.loads(ln)['text'] for ln in f if ln.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='train an interpolated-KN ARPA n-gram LM')
    parser.add_argument('--manifest', default='',
                        help='CSV/JSONL manifest; transcripts from `text`')
    parser.add_argument('--text', default='',
                        help='plain text file, one sentence per line')
    parser.add_argument('--out', required=True, help='output .arpa path')
    parser.add_argument('--order', type=int, default=3)
    parser.add_argument('--prune-count', type=int, default=0,
                        help='drop n>=2 grams with raw count <= this')
    args = parser.parse_args(argv)
    if not (args.manifest or args.text):
        parser.error('need --manifest or --text')

    from .decoding.arpa_lm import PyArpaLM
    from .decoding.ngram_train import train_arpa

    sents = read_sentences(args.manifest, args.text)
    lm = train_arpa(sents, args.out, order=args.order,
                    prune_count=args.prune_count)
    # Self-check: reload through the scorer and report the train-set
    # perplexity (a wildly high number means something upstream is off).
    py = PyArpaLM(args.out)
    logp = n = 0
    for s in sents:
        logp += py.score(s)
        n += len(s.split()) + 1
    ppl = 10 ** (-logp / max(n, 1))
    print(json.dumps({
        'out': args.out, 'order': lm.order, 'sentences': len(sents),
        'vocab': len(lm.vocab),
        'ngrams': [len(lm._kept(k)) for k in range(1, lm.order + 1)],
        'train_ppl': round(ppl, 2),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
