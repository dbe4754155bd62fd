"""CTC decoders and string metrics (host side, numpy in, strings out).

The counterpart of ``wav2letter_pytorch_tpu.decoding.decoder``, same API:

* ``Decoder``: label bookkeeping and WER/CER;
* ``GreedyDecoder``: argmax ids -> collapse repeats, drop blanks, per-char
  frame offsets (the host library's ``greedy.cpp``);
* ``prefix_beam_search``: probability-space CTC prefix beam search in
  float64 Python, with LM weighting at word boundaries, a word-count bonus
  and hotword biasing (``HotwordTrie``);
* ``IncrementalPrefixBeam``: the same search fed chunk by chunk;
* ``PrefixBeamSearchLMDecoder``: the decoder over the C++ search
  (``csrc/host/beam_search.cpp``) or the Python one;
* ``get_time_per_word``: char offsets -> (word, start, end).

The batched search on the eval step's device is ``beam_device``.
"""

from __future__ import annotations

import ctypes
import math
import re
from collections import Counter, defaultdict

import numpy as np

from . import levenshtein
from .._build import load_host
from ..data.label_sets import resolve_labels

_WORD_RE = re.compile(r'\w+[\s|>]')

# Default beam hyperparameters of the decoder classes: the JAX package's
# corpus sweep (benchmarks/beam_sweep.py there) found alpha's winning
# plateau at [0.1, 0.2] with k and beta flat. The low-level
# ``prefix_beam_search`` keeps its own older defaults (k=5, alpha=0.3,
# beta=5). Without an LM, beam ~= greedy is expected (alpha is moot and
# beta=0 removes the word-count bonus).
DEFAULT_BEAM_K = 8
DEFAULT_BEAM_ALPHA = 0.15
DEFAULT_BEAM_BETA = 0.0
DEFAULT_BEAM_PRUNE = 1e-3

_I32P = ctypes.POINTER(ctypes.c_int32)


def _greedy_collapse(sequence, size: int, blank_index: int):
    """(ids, offsets) of the non-blank, non-repeated frames of
    ``sequence[:size]``."""
    lib = load_host()
    ids = np.ascontiguousarray(sequence[:size], dtype=np.int32)
    out_ids = np.empty(max(size, 1), np.int32)
    out_off = np.empty(max(size, 1), np.int32)
    n = lib.w2l_greedy_collapse(ids.ctypes.data_as(_I32P), size, blank_index,
                                out_ids.ctypes.data_as(_I32P),
                                out_off.ctypes.data_as(_I32P))
    return out_ids[:n].tolist(), out_off[:n].copy()


class Decoder:
    """Base decoder: label bookkeeping + string metrics.

    Args:
        labels: list of characters (or a label-set name, resolved via
            ``label_sets.labels_map``).
        blank_index: index of the CTC blank. Defaults to 0.
    """

    def __init__(self, labels, blank_index: int = 0):
        self.labels = resolve_labels(labels)
        self.int_to_char = dict(enumerate(self.labels))
        self.blank_index = blank_index
        # Out-of-range sentinel when the set has no space.
        self.space_index = (self.labels.index(' ') if ' ' in self.labels
                            else len(self.labels))

    # --- metrics -------------------------------------------------------
    def wer(self, s1: str, s2: str) -> int:
        """Word-level edit distance between two space-separated sentences."""
        vocab = {w: i for i, w in enumerate(set(s1.split() + s2.split()))}
        w1 = [vocab[w] for w in s1.split()]
        w2 = [vocab[w] for w in s2.split()]
        return levenshtein.distance(w1, w2)

    def cer(self, s1: str, s2: str) -> int:
        """Character-level edit distance, ignoring spaces."""
        return levenshtein.distance(s1.replace(' ', ''), s2.replace(' ', ''))

    def cer_ratio(self, expected: str, predicted: str):
        """(distance, denominator) pair for corpus-level aggregation."""
        return self.cer(expected, predicted), len(expected.replace(' ', ''))

    def wer_ratio(self, expected: str, predicted: str):
        return self.wer(expected, predicted), len(expected.split())

    # --- decoding ------------------------------------------------------
    def decode(self, probs, sizes=None):
        """Return the decoder's best transcription guess for ``probs``."""
        raise NotImplementedError


class GreedyDecoder(Decoder):
    """Argmax decoding: collapse repeats, strip blanks, report offsets."""

    def process_sequence(self, sequence, size: int):
        """Collapse one argmax id sequence into a string + per-char offsets
        (the host library's ``greedy.cpp``)."""
        ids, offsets = _greedy_collapse(sequence, int(size), self.blank_index)
        chars = [' ' if i == self.space_index else self.int_to_char[i]
                 for i in ids]
        return ''.join(chars), offsets

    def decode(self, probs, sizes=None, return_offsets: bool = False):
        """Decode a [T, L] matrix or [B, T, L] batch of probabilities.

        Returns a list of strings (one per batch element), plus per-char
        time offsets when ``return_offsets`` is set.
        """
        probs = np.asarray(probs)
        if probs.ndim == 2:
            probs = probs[None]
        return self.decode_ids(np.argmax(probs, axis=2), sizes,
                               return_offsets)

    def decode_ids(self, ids, sizes=None, return_offsets: bool = False):
        """Decode pre-argmaxed label ids [B, T].

        The argmax runs on the device, so only [B, T] ints cross to the
        host.
        """
        ids = np.asarray(ids)
        strings, offsets = [], []
        for b in range(ids.shape[0]):
            size = int(sizes[b]) if sizes is not None else ids.shape[1]
            s, off = self.process_sequence(ids[b], size)
            strings.append(s)
            offsets.append(off)
        if return_offsets:
            return strings, offsets
        return strings


def parse_beam_params(text: str) -> dict:
    """``'k=16,alpha=0.4,beta=0,prune=1e-3'`` -> kwargs for the beam
    decoders (the ``--beam-search-params`` format of ``evaluate.py``)."""
    out = {}
    if not text:
        return out
    for part in text.split(','):
        key, _, val = part.partition('=')
        key = key.strip()
        if key not in ('k', 'alpha', 'beta', 'prune'):
            raise ValueError(f'Unknown beam-search param {key!r}')
        out[key] = int(val) if key == 'k' else float(val)
    return out


class HotwordTrie:
    """Contextual biasing weights for the prefix beam search (shallow
    fusion with per-character partial credit, the FlexCTC-style scheme:
    arXiv:2508.07315 §contextual biasing).

    Boost-at-completion alone fails — a weakly-emitted hotword is pruned
    off the beam before its final character. Instead every character that
    extends a prefix of a hotword multiplies the path mass by
    ``weight`` (partial credit), and the accumulated credit is cancelled
    the moment the partial word diverges (handled by the unit delta going
    negative) or completes as a non-hotword. Multi-word phrases are split
    into their words.
    """

    def __init__(self, hotwords, weight: float = 2.0):
        words = {w for phrase in hotwords for w in str(phrase).split() if w}
        if not words:
            raise ValueError('no hotwords given')
        if weight <= 0:
            raise ValueError(f'hotword weight must be > 0, got {weight}')
        self.words = words
        self.weight = float(weight)
        self._prefixes = {w[:i] for w in words for i in range(1, len(w) + 1)}

    def units(self, partial: str) -> int:
        """Matched-character count: len(partial) while it can still become
        a hotword, else 0."""
        return len(partial) if partial in self._prefixes else 0

    def extend(self, partial: str, c: str) -> float:
        """Mass multiplier for extending the in-progress word by ``c``."""
        return self.weight ** (self.units(partial + c) - self.units(partial))

    def complete(self, word: str) -> float:
        """Mass multiplier at a word boundary: keep the credit for a full
        hotword, cancel it for anything else."""
        return 1.0 if word in self.words \
            else self.weight ** (-self.units(word))


def _last_partial(prefix: str) -> str:
    """Characters of the in-progress (post-last-space) word."""
    return prefix.rsplit(' ', 1)[-1]


def prefix_beam_search(ctc, labels, blank_index: int = 0, lm=None,
                       k: int = 5, alpha: float = 0.3, beta: float = 5,
                       prune: float = 0.001,
                       end_char: str = '>', return_weights: bool = False,
                       hotwords=None, hotword_weight: float = 2.0,
                       return_nbest: int = 0):
    """CTC prefix beam search (probability space) with optional LM fusion.

    The classic algorithm (Hannun et al., 2014): maintain, per prefix, the
    probability mass of paths ending in blank (``p_b``) vs non-blank
    (``p_nb``); extend with every character whose per-step emission exceeds
    ``prune``; weight word completions (space or ``end_char``) by
    ``lm(prefix)**alpha``; rank beams by total mass times the word-count
    bonus ``(num_words + 1)**beta``.

    Same argument surface and bookkeeping as
    ``wav2letter_pytorch_tpu.decoding.decoder.prefix_beam_search``, the
    "discarded prefixes" re-merge step included.

    Args:
        ctc: [T, L] array of per-step label *probabilities* (must be >= 0).
        labels: list of characters aligned with the L axis.
        lm: callable str -> probability, or None (constant 1).
        hotwords: optional words/phrases to bias toward (HotwordTrie
            partial-credit shallow fusion); None for none.
    Returns:
        The decoded string; with ``return_weights``, a (string, score) pair.
    """
    ctc = np.asarray(ctc)
    assert ctc.ndim == 2, f'expected [T, L], got shape {ctc.shape}'
    assert ctc.shape[1] == len(labels), (
        f'ctc width {ctc.shape[1]} != len(labels) {len(labels)}')
    assert ctc.shape[0] > 1, f'ctc length {ctc.shape[0]} too short'
    assert (ctc >= 0).all(), 'ctc must be probabilities (non-negative)'
    lm = (lambda _: 1) if lm is None else lm
    trie = None if hotwords is None else (
        hotwords if isinstance(hotwords, HotwordTrie)
        else HotwordTrie(hotwords, hotword_weight))
    num_words = lambda s: len(_WORD_RE.findall(s))
    blank_char = labels[blank_index]

    # Sentinel zero row so indexing starts at t=1 (a previous step always
    # exists).
    ctc = np.vstack([np.zeros(ctc.shape[1]), ctc])
    T = ctc.shape[0]

    p_b = defaultdict(Counter)   # p_b[t][prefix]
    p_nb = defaultdict(Counter)  # p_nb[t][prefix]
    p_b[0][''] = 1.0
    p_nb[0][''] = 0.0
    beams = ['']
    scores = None

    for t in range(1, T):
        step = ctc[t]
        candidates = [(int(i), labels[int(i)])
                      for i in np.where(step > prune)[0]]
        for prefix in beams:
            if prefix and prefix[-1] == end_char:
                # Sentence already terminated: carry mass unchanged.
                p_b[t][prefix] = p_b[t - 1][prefix]
                p_nb[t][prefix] = p_nb[t - 1][prefix]
                continue
            prev_total = p_b[t - 1][prefix] + p_nb[t - 1][prefix]
            for c_ix, c in candidates:
                p_c = step[c_ix]
                if c == blank_char:
                    p_b[t][prefix] += step[blank_index] * prev_total
                    continue
                extended = prefix + c
                if prefix and c == prefix[-1]:
                    # Repeat char: extend only from blank-terminated paths;
                    # same-char continuation stays on the shorter prefix.
                    w_h = trie.extend(_last_partial(prefix), c) \
                        if trie is not None else 1.0
                    p_nb[t][extended] += w_h * p_c * p_b[t - 1][prefix]
                    p_nb[t][prefix] += p_c * p_nb[t - 1][prefix]
                elif prefix.replace(' ', '') and c in (' ', end_char):
                    # Word boundary: apply the language model (and settle
                    # the hotword partial credit: keep for a full match,
                    # cancel otherwise).
                    lm_prob = lm(extended.strip(' ' + end_char)) ** alpha
                    if trie is not None:
                        lm_prob *= trie.complete(_last_partial(prefix))
                    p_nb[t][extended] += lm_prob * p_c * prev_total
                else:
                    w_h = trie.extend(_last_partial(prefix), c) \
                        if trie is not None else 1.0
                    p_nb[t][extended] += w_h * p_c * prev_total
                if extended not in beams:
                    # Re-merge mass of prefixes that fell off the beam.
                    p_b[t][extended] += step[blank_index] * (
                        p_b[t - 1][extended] + p_nb[t - 1][extended])
                    p_nb[t][extended] += p_c * p_nb[t - 1][extended]

        scores = p_b[t] + p_nb[t]
        rank = lambda s: scores[s] * (num_words(s) + 1) ** beta
        beams = sorted(scores, key=rank, reverse=True)[:k]

    if not beams:
        beams = ['']
    best = beams[0]
    if return_nbest:
        # (hypothesis, ranked score) pairs, best first — rescoring surface
        # (the final beams are already rank-sorted).
        return [(b, (scores[b] if scores else 1.0)
                 * (num_words(b) + 1) ** beta)
                for b in beams[:return_nbest]]
    if return_weights:
        return best, scores[best] * (num_words(best) + 1) ** beta
    return best


class IncrementalPrefixBeam:
    """Resumable CTC prefix beam search: feed ``[T, L]`` probability chunks
    as they arrive; the carried state is just (p_b, p_nb, beams) since each
    DP step reads only t-1. ``result()`` after N chunks equals
    ``prefix_beam_search`` on their concatenation (same bookkeeping,
    including the discarded-prefix re-merge — Counters default to 0 exactly
    like the per-t defaultdicts). Powers streaming beam transcription
    (the JAX package's serving/streaming.py::StreamingBeamTranscriber)."""

    def __init__(self, labels, blank_index: int = 0, lm=None, k: int = 5,
                 alpha: float = 0.3, beta: float = 5, prune: float = 0.001,
                 end_char: str = '>', hotwords=None,
                 hotword_weight: float = 2.0):
        self.labels = list(labels)
        self.blank_index = blank_index
        self.lm = (lambda _: 1) if lm is None else lm
        self.k, self.alpha, self.beta = k, alpha, beta
        self.prune, self.end_char = prune, end_char
        self.trie = None if hotwords is None else (
            hotwords if isinstance(hotwords, HotwordTrie)
            else HotwordTrie(hotwords, hotword_weight))
        self._p_b = Counter({'': 1.0})
        self._p_nb = Counter({'': 0.0})
        self._beams = ['']
        # log10 of the total mass divided out by renormalization (see
        # step()); result(return_weights=True) weights are in the
        # rescaled domain — true log10 weight = log10(weight) + this.
        self.renorm_log10 = 0.0

    def step(self, ctc) -> str:
        """Consume a [T, L] chunk of probabilities; returns current best."""
        ctc = np.asarray(ctc)
        assert ctc.ndim == 2, f'expected [T, L], got shape {ctc.shape}'
        assert ctc.shape[1] == len(self.labels), (
            f'ctc width {ctc.shape[1]} != len(labels) {len(self.labels)}')
        assert (ctc >= 0).all(), 'ctc must be probabilities (non-negative)'
        labels, blank_index = self.labels, self.blank_index
        blank_char = labels[blank_index]
        end_char = self.end_char
        num_words = lambda s: len(_WORD_RE.findall(s))
        for step in ctc:
            p_b_prev, p_nb_prev = self._p_b, self._p_nb
            p_b, p_nb = Counter(), Counter()
            candidates = [(int(i), labels[int(i)])
                          for i in np.where(step > self.prune)[0]]
            for prefix in self._beams:
                if prefix and prefix[-1] == end_char:
                    p_b[prefix] = p_b_prev[prefix]
                    p_nb[prefix] = p_nb_prev[prefix]
                    continue
                prev_total = p_b_prev[prefix] + p_nb_prev[prefix]
                for c_ix, c in candidates:
                    p_c = step[c_ix]
                    if c == blank_char:
                        p_b[prefix] += step[blank_index] * prev_total
                        continue
                    extended = prefix + c
                    if prefix and c == prefix[-1]:
                        w_h = self.trie.extend(_last_partial(prefix), c) \
                            if self.trie is not None else 1.0
                        p_nb[extended] += w_h * p_c * p_b_prev[prefix]
                        p_nb[prefix] += p_c * p_nb_prev[prefix]
                    elif prefix.replace(' ', '') and c in (' ', end_char):
                        lm_prob = self.lm(
                            extended.strip(' ' + end_char)) ** self.alpha
                        if self.trie is not None:
                            lm_prob *= self.trie.complete(
                                _last_partial(prefix))
                        p_nb[extended] += lm_prob * p_c * prev_total
                    else:
                        w_h = self.trie.extend(_last_partial(prefix), c) \
                            if self.trie is not None else 1.0
                        p_nb[extended] += w_h * p_c * prev_total
                    if extended not in self._beams:
                        p_b[extended] += step[blank_index] * (
                            p_b_prev[extended] + p_nb_prev[extended])
                        p_nb[extended] += p_c * p_nb_prev[extended]
            scores = p_b + p_nb
            rank = lambda s: scores[s] * (num_words(s) + 1) ** self.beta
            self._beams = sorted(scores, key=rank, reverse=True)[:self.k] \
                or ['']
            self._p_b, self._p_nb = p_b, p_nb
        # Unbounded streams: the raw-probability DP underflows float64
        # after ~6k frames (a product of that many frame probabilities is
        # exactly 0.0). A uniform rescale of every prefix mass is exactly
        # ranking-preserving — the recursion and the rank are linear in
        # the masses — so renormalize by the leader once it shrinks below
        # 1e-30; short inputs never trigger it (bit-exact parity with the
        # one-shot search preserved).
        top = self._p_b[self._beams[0]] + self._p_nb[self._beams[0]]
        if 0.0 < top < 1e-30:
            inv = 1.0 / top
            self._p_b = Counter({p: v * inv for p, v in self._p_b.items()})
            self._p_nb = Counter({p: v * inv
                                  for p, v in self._p_nb.items()})
            self.renorm_log10 += math.log10(top)
        return self._beams[0]

    def result(self, return_weights: bool = False):
        best = self._beams[0]
        if return_weights:
            score = (self._p_b[best] + self._p_nb[best]) \
                * (len(_WORD_RE.findall(best)) + 1) ** self.beta
            return best, score
        return best


class PrefixBeamSearchLMDecoder(Decoder):
    """Beam-search decoder with an optional ARPA language model.

    ``lm_path`` may be empty (no LM). Hyperparameter defaults are the
    corpus-sweep winners (DEFAULT_BEAM_*, see the module-level note).
    """

    def __init__(self, lm_path, labels, blank_index: int = 0,
                 k: int = DEFAULT_BEAM_K, alpha: float = DEFAULT_BEAM_ALPHA,
                 beta: float = DEFAULT_BEAM_BETA,
                 prune: float = DEFAULT_BEAM_PRUNE,
                 backend: str = 'auto', hotwords=None,
                 hotword_weight: float = 2.0):
        """``backend``: 'native' (and 'auto', its alias) runs the host
        library's C++ search with its ARPA scorer (``csrc/host/``, built
        at first use; a failed build raises); 'python' runs the Python DP
        with ``arpa_lm.load_lm``'s scorer (kenlm when installed). Both
        give the same strings.

        ``hotwords``: contextual-biasing words/phrases (HotwordTrie
        partial-credit fusion), implemented identically in the Python DP
        and the C++ search."""
        super().__init__(labels, blank_index)
        if backend not in ('auto', 'native', 'python'):
            raise ValueError(f'unknown backend {backend!r} (expected '
                             "'auto', 'native' or 'python')")
        self.trie = None if hotwords is None else HotwordTrie(
            hotwords, hotword_weight)
        self._use_native = backend != 'python'
        self._native_lm = None
        if self._use_native:
            load_host()
            if lm_path:
                from .arpa_lm import ArpaLM
                self._native_lm = ArpaLM(lm_path)
        elif lm_path:
            from .arpa_lm import load_lm
            self._lm_model = load_lm(lm_path)
            self.lm_weigh = lambda s: 10 ** self._lm_model.score(s)
        else:
            self.lm_weigh = lambda s: 1
        self.k = k
        self.alpha = alpha
        self.beta = beta
        self.prune = prune

    def decode(self, probs, sizes=None, return_offsets: bool = False):
        """Decode [T, L] probabilities (or a [B, T, L] batch, one search a
        sample).

        ``return_offsets`` returns per-char frame offsets computed by
        Viterbi-force-aligning the winning hypothesis back to the same
        probabilities (decoding.forced_align) — exact, since every beam
        prefix is the emission of at least one feasible CTC path.
        ``sizes`` truncates each sample before decode (and alignment).
        """
        probs = np.asarray(probs)
        if probs.ndim == 2:
            if self._use_native:
                from .beam_native import prefix_beam_search_native
                text = prefix_beam_search_native(
                    probs, self.labels, self.blank_index, self._native_lm,
                    self.k, self.alpha, self.beta, self.prune,
                    hotwords=self.trie)
            else:
                text = prefix_beam_search(
                    probs, self.labels, self.blank_index, self.lm_weigh,
                    self.k, self.alpha, self.beta, self.prune,
                    hotwords=self.trie)
            if not return_offsets:
                return text
            return text, _beam_offsets(probs, text, self.labels,
                                       self.blank_index)
        if probs.ndim == 3:
            rows = [probs[b] if sizes is None else probs[b, :int(sizes[b])]
                    for b in range(probs.shape[0])]
            if not return_offsets:
                return [self.decode(p) for p in rows]
            pairs = [self.decode(p, return_offsets=True) for p in rows]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        raise RuntimeError(
            f'Decoding with wrong shape: {probs.shape}, expected '
            '[Batch x Frames x Labels] or [Frames x Labels]')


def _beam_offsets(probs, text: str, labels, blank_index: int):
    """Per-char first-emission frames for a beam hypothesis: Viterbi
    forced alignment of ``text`` against the probabilities it was decoded
    from (GreedyDecoder offset convention: one offset per decoded char,
    spaces included)."""
    if not text:
        return np.zeros((0,), np.int32)
    from .forced_align import forced_align
    lp = np.log(np.clip(np.asarray(probs, np.float64), 1e-30, None))
    # Always feasible: the DP only builds prefixes that at least one
    # monotone CTC path emits (repeats are extended via blank paths only).
    spans = forced_align(lp, text, labels, blank_index)
    return np.asarray([start for _, start, _ in spans], np.int32)


def get_time_per_word(predictions, offsets, ratio: float = 1.0):
    """Convert per-char decoder offsets into (word, start, end) tuples.

    ``ratio`` converts frame offsets to seconds; for the standard frontend it
    equals window_stride (seconds) x model scaling factor. End times use the
    first occurrence of a word's last character.
    """
    assert len(predictions) == len(offsets)
    word_times = []
    current, start, end = '', -1, -1
    for letter, offset in zip(predictions, offsets):
        if letter == ' ':
            if current:
                word_times.append((current, start, end))
                current, start, end = '', -1, -1
            continue
        if current:
            end = offset * ratio
            current += letter
        else:
            start = end = offset * ratio
            current = letter
    if current:
        word_times.append((current, start, end))
    return word_times
