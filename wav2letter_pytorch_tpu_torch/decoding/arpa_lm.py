"""ARPA n-gram language model with kenlm-compatible scoring.

The counterpart of ``wav2letter_pytorch_tpu.decoding.arpa_lm``:
``ArpaLM`` scores through the port's host library
(``csrc/host/arpa_lm.cpp``, built at first use; a failed build raises),
``PyArpaLM`` is the same scorer in Python, and ``load_lm`` picks kenlm when
it is installed, else ``ArpaLM``. Every scorer has kenlm's
``score(sentence, bos=True, eos=True) -> log10 prob`` with Katz backoff and
<s>/</s>/<unk> handling.
"""

from __future__ import annotations

from .._build import load_host


class ArpaLM:
    """kenlm.Model-compatible ARPA scorer (log10 probabilities)."""

    def __init__(self, path: str):
        self._lib = load_host()
        self._handle = self._lib.w2l_arpa_load(path.encode())
        if not self._handle:
            raise ValueError(f'failed to load ARPA model from {path!r}')

    @property
    def order(self) -> int:
        return self._lib.w2l_arpa_order(self._handle)

    def score(self, sentence: str, bos: bool = True,
              eos: bool = True) -> float:
        """log10 probability of the sentence (kenlm-compatible)."""
        return self._lib.w2l_arpa_score(self._handle, sentence.encode(),
                                        int(bos), int(eos))

    def __del__(self):
        handle = getattr(self, '_handle', None)
        if handle:
            self._lib.w2l_arpa_free(handle)
            self._handle = None


class PyArpaLM:
    """Pure-Python ARPA scorer, same semantics as the C++ one.

    An independent oracle the tests hold the C++ scorer against (fixtures
    and fuzzed models). Same kenlm-compatible contract: Katz backoff, OOV
    -> <unk> (log10 -100 when the model has no <unk>, kenlm's
    ``unknown_missing_logprob`` default), ``score(s, bos, eos)`` in log10.
    """

    UNK_FLOOR = -100.0

    def __init__(self, path: str):
        # grams[n-1]: tuple-key map -> (logp, backoff)
        self.grams: list[dict] = []
        self.order = 0
        section = 0
        with open(path, encoding='utf-8', errors='replace') as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith('\\'):
                    if line == '\\data\\' or line == '\\end\\':
                        section = 0
                        continue
                    try:
                        section = int(line[1:line.index('-')])
                    except ValueError:
                        section = 0
                    continue
                if section <= 0:
                    if line.startswith('ngram '):
                        n = int(line[6:line.index('=')])
                        self.order = max(self.order, n)
                        while len(self.grams) < n:
                            self.grams.append({})
                    continue
                parts = line.split()
                if len(parts) < section + 1:
                    continue
                logp = float(parts[0])
                if len(parts) == section + 2:
                    words, backoff = tuple(parts[1:-1]), float(parts[-1])
                elif len(parts) == section + 1:
                    words, backoff = tuple(parts[1:]), 0.0
                else:
                    continue  # malformed
                while len(self.grams) < section:
                    self.grams.append({})
                self.grams[section - 1][words] = (logp, backoff)
        if self.order == 0:
            raise ValueError(f'failed to load ARPA model from {path!r}')
        self.has_unk = bool(self.grams) and ('<unk>',) in self.grams[0]

    def _cond(self, words: tuple) -> float:
        n = len(words)
        if n <= len(self.grams):
            hit = self.grams[n - 1].get(words)
            if hit is not None:
                return hit[0]
        if n == 1:
            if self.has_unk:
                return self.grams[0][('<unk>',)][0]
            return self.UNK_FLOOR
        ctx = self.grams[n - 2].get(words[:-1]) if n - 1 <= len(self.grams) \
            else None
        bo = ctx[1] if ctx is not None else 0.0
        return bo + self._cond(words[1:])

    def score(self, sentence: str, bos: bool = True,
              eos: bool = True) -> float:
        words = ['<s>'] if bos else []
        for w in sentence.split():
            if self.has_unk and (w,) not in self.grams[0]:
                w = '<unk>'
            words.append(w)
        if eos:
            words.append('</s>')
        total = 0.0
        for i in range(1 if bos else 0, len(words)):
            begin = max(0, i + 1 - self.order)
            total += self._cond(tuple(words[begin:i + 1]))
        return total


def load_lm(path: str):
    """kenlm if importable, else the host library's ``ArpaLM``: the same
    ``.score`` API either way."""
    try:
        import kenlm
    except ImportError:
        return ArpaLM(path)
    return kenlm.Model(path)
