"""The port's host decoding vs the JAX package's on the same numpy arrays.

Exact: edit distance (library and Python), alignment, greedy strings and
offsets, word timings, forced alignment. String-exact (and, for the
float64 Python DP, bit-equal scores): the prefix beam search LM-free, with
a callable LM and with hotwords; ``PrefixBeamSearchLMDecoder`` on its
Python and C++ backends with an ARPA LM; ``IncrementalPrefixBeam``.
"""

import numpy as np
import pytest
import torch

from wav2letter_pytorch_tpu.decoding import decoder as jdec
from wav2letter_pytorch_tpu.decoding.forced_align import \
    forced_align as jax_forced_align
from wav2letter_pytorch_tpu.decoding.forced_align import \
    word_alignments as jax_word_alignments
from wav2letter_pytorch_tpu.decoding import levenshtein as jlev
from wav2letter_pytorch_tpu.decoding import ngram_train as jax_ngram
from wav2letter_pytorch_tpu_torch import _build
from wav2letter_pytorch_tpu_torch.decoding import decoder as pdec
from wav2letter_pytorch_tpu_torch.decoding.forced_align import (
    forced_align, word_alignments)
from wav2letter_pytorch_tpu_torch.decoding import levenshtein as plev
from wav2letter_pytorch_tpu_torch.decoding.beam_native import (
    native_available, prefix_beam_search_native)

torch.set_num_threads(1)

LABELS = list("_'abcdefghijklmnopqrstuvwxyz ")
V = len(LABELS)
WORDS = ['the', 'cat', 'sat', 'on', 'a', 'mat', 'dog', 'ran']


def _random_probs(rng, T, V, peaky=True):
    logits = rng.standard_normal((T, V)) * (3.0 if peaky else 1.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _spelled_probs(rng, text, frames_per_char=3, floor=0.02):
    """Probabilities that spell ``text`` (a blank between chars), with
    noise: the searches then meet real words, word boundaries and LM
    weights."""
    rows = []
    for ch in text:
        for f in range(frames_per_char):
            row = rng.uniform(0, floor, V)
            row[LABELS.index(ch) if f < frames_per_char - 1 else 0] += 1.0
            rows.append(row / row.sum())
    return np.stack(rows)


@pytest.fixture(scope='module')
def lm_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    sents = [' '.join(rng.choice(WORDS, size=int(rng.integers(2, 6))))
             for _ in range(50)]
    path = tmp_path_factory.mktemp('lm') / 'lm.arpa'
    jax_ngram.train_arpa(sents, str(path), order=3)
    return str(path)


# ------------------------------------------------------------ levenshtein

PAIRS = [('the cat sat', 'the cat sat'), ('kitten', 'sitting'),
         ('abc', ''), ('', 'x y'), ('', ''), ('שלום', 'שלם'),
         ([1, 2, 3, 4], [2, 3, 5]), ([7] * 30, [7, 8] * 12)]


@pytest.mark.parametrize('a,b', PAIRS)
def test_distance_and_align_match_jax(a, b):
    want = jlev.distance(a, b)
    assert plev.distance(a, b) == want
    assert plev._py_distance(list(a), list(b)) == want
    assert plev.align(a, b) == jlev.align(a, b)
    assert sum(op != 'ok' for op, _, _ in plev.align(a, b)) == want


def test_batch_distance_matches_jax():
    rng = np.random.default_rng(3)
    pairs = PAIRS + [(rng.integers(0, 5, int(rng.integers(0, 20))).tolist(),
                      rng.integers(0, 5, int(rng.integers(0, 20))).tolist())
                     for _ in range(20)]
    assert plev.batch_distance(pairs) == jlev.batch_distance(pairs)
    assert plev.batch_distance([]) == []
    assert native_available()
    assert _build.load_host() is _build.load_host()


# ----------------------------------------------------------------- greedy

@pytest.mark.parametrize('labels', ['english_lowercase', 'hebrew'])
def test_greedy_strings_and_offsets_match_jax(labels):
    rng = np.random.default_rng(1)
    ours, theirs = pdec.GreedyDecoder(labels), jdec.GreedyDecoder(labels)
    n = len(ours.labels)
    ids = np.repeat(rng.integers(0, n, size=(4, 30)), 2, axis=1)
    sizes = np.array([60, 41, 1, 0])
    for args in ((ids, sizes), (ids, None)):
        s1, o1 = ours.decode_ids(*args, return_offsets=True)
        s2, o2 = theirs.decode_ids(*args, return_offsets=True)
        assert s1 == s2
        for a, b in zip(o1, o2):
            np.testing.assert_array_equal(a, b)
    probs = rng.random((3, 25, n))
    assert ours.decode(probs, [25, 10, 3]) == \
        theirs.decode(probs, [25, 10, 3])
    assert ours.decode(probs[0]) == theirs.decode(probs[0])


@pytest.mark.parametrize('ratio', [1.0, 0.02])
def test_time_per_word_matches_jax(ratio):
    rng = np.random.default_rng(2)
    dec = pdec.GreedyDecoder(LABELS)
    ids = rng.choice([0, 0, 0, 2, 3, 28, 28, 5], size=(3, 60))
    strings, offsets = dec.decode_ids(ids, return_offsets=True)
    for s, off in zip(strings, offsets):
        assert pdec.get_time_per_word(list(s), off.tolist(), ratio) == \
            jdec.get_time_per_word(list(s), off.tolist(), ratio)
    assert pdec.get_time_per_word([], [], ratio) == []


# ---------------------------------------------------------- forced align

@pytest.mark.parametrize('text', ['the cat', 'a', 'aa b', 'sat on a mat'])
def test_forced_align_and_word_alignments_match_jax(text):
    rng = np.random.default_rng(len(text))
    lp = np.log(_random_probs(rng, 4 * len(text) + 3, V, peaky=False))
    assert forced_align(lp, text, LABELS) == \
        jax_forced_align(lp, text, LABELS)
    assert word_alignments(lp, text, LABELS, frame_seconds=0.02) == \
        jax_word_alignments(lp, text, LABELS, frame_seconds=0.02)


def test_forced_align_errors():
    lp = np.zeros((2, V))
    with pytest.raises(ValueError, match='cannot emit'):
        forced_align(lp, 'aa', LABELS)
    with pytest.raises(ValueError, match='not in labels'):
        forced_align(lp, 'A', LABELS)
    assert forced_align(lp, '', LABELS) == []


# ------------------------------------------------------------ beam search

def test_parse_beam_params_and_hotword_trie():
    text = 'k=16,alpha=0.4,beta=0,prune=1e-3'
    assert pdec.parse_beam_params(text) == jdec.parse_beam_params(text)
    assert pdec.parse_beam_params('') == {}
    with pytest.raises(ValueError, match='Unknown'):
        pdec.parse_beam_params('q=1')
    ours = pdec.HotwordTrie(['cat sat', 'mat'], 3.0)
    theirs = jdec.HotwordTrie(['cat sat', 'mat'], 3.0)
    for partial, c in (('', 'c'), ('c', 'a'), ('ca', 't'), ('ca', 'x'),
                       ('m', 'a'), ('dog', 's')):
        assert ours.extend(partial, c) == theirs.extend(partial, c)
        assert ours.complete(partial + c) == theirs.complete(partial + c)
    with pytest.raises(ValueError):
        pdec.HotwordTrie([])


def _lm_callable():
    return lambda s: 0.3 ** len(s.split()) * (2.0 if 'cat' in s else 1.0)


CASES = [  # (seed, peaky, k, alpha, beta, prune, lm, hotwords)
    (0, True, 5, 0.3, 5.0, 1e-3, False, None),
    (1, False, 3, 0.3, 0.0, 1e-2, False, None),
    (2, True, 8, 0.5, 1.0, 1e-3, True, None),
    (3, True, 4, 0.3, 2.0, 1e-3, False, ['cat', 'dog ran']),
    (4, True, 6, 0.8, 1.0, 1e-3, True, ['mat']),
]


@pytest.mark.parametrize('seed,peaky,k,alpha,beta,prune,use_lm,hotwords',
                         CASES)
def test_prefix_beam_search_matches_jax(seed, peaky, k, alpha, beta, prune,
                                        use_lm, hotwords):
    rng = np.random.default_rng(seed)
    texts = ['the cat sat', 'dog ran on a mat', 'a cat']
    probs = [_random_probs(rng, 30, V, peaky),
             _spelled_probs(rng, texts[seed % 3] + ' ')]
    lm = _lm_callable() if use_lm else None
    for p in probs:
        kw = dict(lm=lm, k=k, alpha=alpha, beta=beta, prune=prune,
                  hotwords=hotwords)
        want = jdec.prefix_beam_search(p, LABELS, return_weights=True, **kw)
        assert pdec.prefix_beam_search(p, LABELS, return_weights=True,
                                       **kw) == want
        assert pdec.prefix_beam_search(p, LABELS, return_nbest=k, **kw) == \
            jdec.prefix_beam_search(p, LABELS, return_nbest=k, **kw)


@pytest.mark.parametrize('backend', ['python', 'native'])
@pytest.mark.parametrize('hotwords', [None, ['cat', 'mat']])
def test_lm_decoder_matches_jax(lm_path, backend, hotwords):
    rng = np.random.default_rng(7)
    probs = np.stack([_spelled_probs(rng, t, 3)[:36] for t in
                      ('the cat sat on a mat', 'a dog ran the mat',
                       'the mat sat on a dog')])
    sizes = np.array([36, 30, 24])
    kw = dict(k=6, alpha=0.5, beta=1.0, hotwords=hotwords)
    ours = pdec.PrefixBeamSearchLMDecoder(lm_path, LABELS, backend=backend,
                                          **kw)
    theirs = jdec.PrefixBeamSearchLMDecoder(lm_path, LABELS,
                                            backend='python', **kw)
    got, got_off = ours.decode(probs, sizes, return_offsets=True)
    want, want_off = theirs.decode(probs, sizes, return_offsets=True)
    assert got == want
    assert any(' ' in s for s in got)
    for a, b in zip(got_off, want_off):
        np.testing.assert_array_equal(a, b)
    assert ours.decode(probs[0]) == want[0]


def test_native_search_matches_python_with_weights(lm_path):
    from wav2letter_pytorch_tpu_torch.decoding.arpa_lm import ArpaLM
    rng = np.random.default_rng(11)
    lm = ArpaLM(lm_path)
    for p in (_random_probs(rng, 40, V), _spelled_probs(rng, 'a cat sat ')):
        text, w = prefix_beam_search_native(p, LABELS, lm=lm, k=5,
                                            alpha=0.4, beta=1.0,
                                            return_weights=True)
        want, want_w = pdec.prefix_beam_search(
            p.astype(np.float32), LABELS, lm=lambda s: 10 ** lm.score(s),
            k=5, alpha=0.4, beta=1.0, return_weights=True)
        assert text == want
        assert w == pytest.approx(want_w, rel=1e-9)
    with pytest.raises(TypeError, match='ArpaLM'):
        prefix_beam_search_native(p, LABELS, lm=_lm_callable())
    with pytest.raises(ValueError, match='backend'):
        pdec.PrefixBeamSearchLMDecoder('', LABELS, backend='gpu')


@pytest.mark.parametrize('chunks', [[40], [7, 13, 20], [1] * 10 + [30]])
def test_incremental_beam_matches_jax(chunks):
    rng = np.random.default_rng(5)
    probs = _random_probs(rng, sum(chunks), V)
    kw = dict(lm=_lm_callable(), k=5, alpha=0.3, beta=1.0,
              hotwords=['cat'])
    ours, theirs = pdec.IncrementalPrefixBeam(LABELS, **kw), \
        jdec.IncrementalPrefixBeam(LABELS, **kw)
    start = 0
    for n in chunks:
        assert ours.step(probs[start:start + n]) == \
            theirs.step(probs[start:start + n])
        start += n
    assert ours.result(return_weights=True) == \
        theirs.result(return_weights=True)
    assert ours.result() == pdec.prefix_beam_search(probs, LABELS, **kw)
