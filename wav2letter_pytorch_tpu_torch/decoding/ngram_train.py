"""N-gram language-model training: interpolated Kneser-Ney -> ARPA.

The counterpart of ``wav2letter_pytorch_tpu.decoding.ngram_train``: the
same estimator writes the same ARPA bytes from the same sentences. Train an
n-gram LM from transcripts with the standard interpolated Kneser-Ney
estimator (the family kenlm's ``lmplz`` implements) and write it as ARPA,
scoreable by every scorer of ``decoding.arpa_lm`` and usable by every beam
decoder in ``decoding``.

Estimator notes (Chen & Goodman 1998; SRILM/kenlm conventions):

* highest order uses raw counts; lower orders use CONTINUATION counts
  (number of distinct left extensions), except n-grams starting with
  ``<s>`` which keep raw counts (nothing can precede ``<s>``);
* one absolute discount per order, ``D = n1 / (n1 + 2*n2)`` from that
  order's count-of-counts;
* interpolation is folded into the stored probabilities, and the leftover
  mass ``lambda(ctx) = D * distinct_continuations(ctx) / total(ctx)``
  becomes the context's ARPA backoff weight — so the written file scores
  identically under the Katz-style backoff rule our scorers implement,
  and each context's distribution sums to 1 over the vocabulary;
* the unigram distribution interpolates with uniform-over-vocab
  (including ``<unk>``), which both smooths rare words and gives ``<unk>``
  a proper probability; ``<s>`` gets the conventional -99 log10 prob;
* pruning (``prune_count``) drops rare higher-order entries at WRITE
  time only — estimation always sees the full tables.
"""

from __future__ import annotations

import math
from collections import Counter

BOS, EOS, UNK = '<s>', '</s>', '<unk>'
LOG10_BOS = -99.0     # conventional "never predict <s>" ARPA entry


def _count_ngrams(sentences, order: int):
    """counts[n-1]: Counter over n-gram tuples (with <s>/</s> padding)."""
    counts = [Counter() for _ in range(order)]
    n_sent = 0
    for sent in sentences:
        words = [BOS] + [w for w in sent.split() if w] + [EOS]
        if len(words) == 2:
            continue
        n_sent += 1
        for n in range(1, order + 1):
            c = counts[n - 1]
            for i in range(len(words) - n + 1):
                c[tuple(words[i:i + n])] += 1
    if not n_sent:
        raise ValueError('no training text')
    return counts


def _adjusted_counts(raw, order: int):
    """Kneser-Ney adjusted counts: highest order raw; for n < order the
    number of DISTINCT left extensions, except grams starting with <s>
    (un-extendable — raw count kept)."""
    adjusted = [Counter() for _ in range(order)]
    adjusted[order - 1] = raw[order - 1]
    for n in range(order - 1, 0, -1):       # n-gram tables below the top
        cont = Counter()
        for gram in raw[n]:                 # raw (n+1)-grams
            cont[gram[1:]] += 1
        adj = adjusted[n - 1]
        for gram, c in raw[n - 1].items():
            adj[gram] = c if gram[0] == BOS else (cont.get(gram, 0) or c)
    return adjusted


def _discount(counter) -> float:
    n1 = sum(1 for c in counter.values() if c == 1)
    n2 = sum(1 for c in counter.values() if c == 2)
    if n1 == 0 or (n1 + 2 * n2) == 0:
        return 0.5
    return n1 / (n1 + 2 * n2)


class NgramLM:
    """Trained interpolated-KN model: ``probs[n-1][gram] -> log10 p``,
    ``backoffs[n-1][gram] -> log10 bow`` (contexts only)."""

    def __init__(self, sentences, order: int = 3, prune_count: int = 0):
        """``sentences``: iterable of transcript strings. ``prune_count``:
        at write time, drop n-grams (n >= 2) with raw count <= this."""
        order = int(order)
        if order < 1:
            raise ValueError('order must be >= 1')
        self.order = order
        self.prune_count = int(prune_count)
        raw = _count_ngrams(sentences, order)
        self._raw = raw
        adj = _adjusted_counts(raw, order)
        D = [_discount(adj[n]) for n in range(order)]

        # Per-context totals / distinct continuations, keyed by context
        # length: tables of (L+1)-grams feed contexts of length L.
        totals = [Counter() for _ in range(order)]
        distinct = [Counter() for _ in range(order)]
        for L in range(1, order):
            for gram, c in adj[L].items():
                totals[L][gram[:-1]] += c
                distinct[L][gram[:-1]] += 1

        vocab = sorted({g[0] for g in adj[0]} | {UNK})
        self.vocab = vocab
        V = len(vocab) - (1 if (BOS,) in adj[0] else 0)  # predictable words

        # Unigrams: absolute discount + uniform interpolation over the
        # predictable vocab (everything except <s>).
        d1 = D[0]
        uni_total = sum(c for g, c in adj[0].items() if g != (BOS,))
        uni_distinct = sum(1 for g in adj[0] if g != (BOS,))
        lam1 = d1 * uni_distinct / max(uni_total, 1)
        probs = [dict() for _ in range(order)]
        backoffs = [dict() for _ in range(order)]
        for w in vocab:
            if w == BOS:
                continue
            a = adj[0].get((w,), 0)
            p = max(a - d1, 0.0) / max(uni_total, 1) + lam1 / V
            probs[0][(w,)] = math.log10(p)
        if (BOS,) in adj[0]:
            probs[0][(BOS,)] = LOG10_BOS

        # Higher orders, low to high (suffix probs already filled — every
        # seen n-gram's suffix is a seen (n-1)-gram).
        for n in range(2, order + 1):
            d = D[n - 1]
            for gram, a in adj[n - 1].items():
                ctx = gram[:-1]
                tot = totals[n - 1][ctx]
                if tot <= 0:
                    continue
                lam = d * distinct[n - 1][ctx] / tot
                lower = probs[n - 2][gram[1:]]
                p = max(a - d, 0.0) / tot + lam * (10.0 ** lower)
                probs[n - 1][gram] = math.log10(max(p, 1e-99))
            # Backoff weight of each length-(n-1) context that appears in
            # the model as its own entry.
            for ctx, tot in totals[n - 1].items():
                if tot > 0 and ctx in probs[n - 2]:
                    lam = d * distinct[n - 1][ctx] / tot
                    backoffs[n - 2][ctx] = math.log10(max(lam, 1e-99))
        self.probs, self.backoffs = probs, backoffs

    def _kept(self, n: int):
        """Entries of order ``n`` surviving pruning (sorted)."""
        if n == 1 or not self.prune_count:
            return sorted(self.probs[n - 1])
        raw = self._raw[n - 1]
        return sorted(g for g in self.probs[n - 1]
                      if raw.get(g, 0) > self.prune_count)

    def write_arpa(self, path: str) -> None:
        kept = [self._kept(n) for n in range(1, self.order + 1)]
        with open(path, 'w', encoding='utf-8') as f:
            f.write('\\data\\\n')
            for n in range(1, self.order + 1):
                f.write(f'ngram {n}={len(kept[n - 1])}\n')
            for n in range(1, self.order + 1):
                f.write(f'\n\\{n}-grams:\n')
                for gram in kept[n - 1]:
                    logp = self.probs[n - 1][gram]
                    bo = self.backoffs[n - 1].get(gram) \
                        if n < self.order else None
                    line = f'{logp:.7f}\t' + ' '.join(gram)
                    if bo is not None and bo != 0.0:
                        line += f'\t{bo:.7f}'
                    f.write(line + '\n')
            f.write('\n\\end\\\n')


def train_arpa(sentences, out_path: str, order: int = 3,
               prune_count: int = 0) -> NgramLM:
    """Train and write in one call; returns the model."""
    lm = NgramLM(sentences, order=order, prune_count=prune_count)
    lm.write_arpa(out_path)
    return lm
