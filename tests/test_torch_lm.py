"""The port's language models vs the JAX package's: ARPA scoring (the host
library's C++ scorer and the Python one) and n-gram training.

Scores agree within 1e-6 in log10 on hand-written fixtures (backoff,
pruned backoffs, <unk>, a model without <unk>, CRLF and e-notation) and on
fuzzed models and sentences; ``train_arpa`` writes the same bytes.
"""

import numpy as np
import pytest
import torch

from wav2letter_pytorch_tpu.decoding import arpa_lm as jax_lm
from wav2letter_pytorch_tpu.decoding import ngram_train as jax_ngram
from wav2letter_pytorch_tpu_torch.decoding import arpa_lm, ngram_train

torch.set_num_threads(1)

# log10 scores: the C++ scorer stores float32 log-probs, the Python one
# float64; a sentence sums a few dozen terms.
SCORE_TOL = 1e-6

TINY_ARPA = """\\data\\
ngram 1=5
ngram 2=4

\\1-grams:
-1.0\t<s>\t-0.5
-1.3\t</s>
-0.7\tthe\t-0.3
-1.0\tcat\t-0.4
-1.2\t<unk>

\\2-grams:
-0.3\t<s> the
-0.5\tthe cat
-0.9\tcat </s>
-1.1\tthe </s>

\\end\\
"""

TRIGRAM_QUIRKS = (
    "\\data\\\r\n"
    "ngram 1=6\r\nngram 2=4\r\nngram 3=2\r\n\r\n"
    "\\1-grams:\r\n"
    "-1.0\tthe\t-0.3\r\n"
    "-8e-1\t<s>\t-0.5\r\n"
    "-1.3\t</s>\r\n"
    "-1.1\tcat\r\n"
    "-1.4\tsat\t-0.2\r\n"
    "-1.9\t<unk>\r\n\r\n"
    "\\2-grams:\r\n"
    "-0.6\tthe cat\t-0.1\r\n"
    "-0.4\t<s> the\t-0.25\r\n"
    "-0.7\tcat sat\r\n"
    "-0.9\tsat </s>\r\n\r\n"
    "\\3-grams:\r\n"
    "-0.2\t<s> the cat\r\n"
    "-0.35\tthe cat sat\r\n\r\n"
    "\\end\\\r\n")

NO_UNK = """\\data\\
ngram 1=3

\\1-grams:
-0.5\t<s>\t-0.4
-0.9\t</s>
-0.6\tthe\t-0.2

\\end\\
"""

FIXTURES = {'tiny': TINY_ARPA, 'quirks': TRIGRAM_QUIRKS, 'no_unk': NO_UNK}
SENTENCES = ['the cat', 'cat the', 'dog', 'zebra dog', 'the cat sat',
             'the sat', 'cat the cat the', '', 'the the the', 'sat cat the']
FLAGS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture(scope='module')
def fixture_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp('arpa')
    paths = {}
    for name, text in FIXTURES.items():
        path = root / f'{name}.arpa'
        path.write_bytes(text.encode())
        paths[name] = str(path)
    return paths


@pytest.mark.parametrize('name', sorted(FIXTURES))
def test_scores_match_jax_on_fixtures(fixture_paths, name):
    path = fixture_paths[name]
    ours = [arpa_lm.ArpaLM(path), arpa_lm.PyArpaLM(path)]
    theirs = jax_lm.PyArpaLM(path)
    assert ours[0].order == ours[1].order == theirs.order
    for sent in SENTENCES:
        for bos, eos in FLAGS:
            want = theirs.score(sent, bos=bos, eos=eos)
            for lm in ours:
                assert abs(lm.score(sent, bos=bos, eos=eos) - want) \
                    <= SCORE_TOL, (type(lm).__name__, sent, bos, eos)


def test_hand_math_backoff_and_unk(fixture_paths):
    lm = arpa_lm.ArpaLM(fixture_paths['tiny'])
    assert lm.order == 2
    assert lm.score('the cat') == pytest.approx(-0.3 - 0.5 - 0.9)
    assert lm.score('cat the') == pytest.approx(-1.5 - 1.1 - 1.1)
    # dog -> <unk>: bo(<s>) + P(<unk>), then P(</s>) through bo(<unk>) = 0
    assert lm.score('dog') == pytest.approx(-1.7 - 1.3)
    assert lm.score('dog') == lm.score('zebra')
    # no <unk> in the model: kenlm's -100 for an unknown word
    no_unk = arpa_lm.ArpaLM(fixture_paths['no_unk'])
    assert no_unk.score('dog', bos=False, eos=False) == pytest.approx(-100.0)


def _corpus(rng, vocab, n):
    return [' '.join(rng.choice(vocab, size=int(rng.integers(1, 9))))
            for _ in range(n)]


@pytest.mark.parametrize('seed,order,prune', [(0, 2, 0), (1, 3, 0),
                                              (2, 3, 1), (3, 4, 0)])
def test_train_arpa_bytes_and_fuzzed_scores_match_jax(tmp_path, seed, order,
                                                      prune):
    rng = np.random.default_rng(seed)
    vocab = [f'w{i}' for i in range(int(rng.integers(5, 15)))]
    sents = _corpus(rng, vocab, 40)
    ours, theirs = tmp_path / 'ours.arpa', tmp_path / 'theirs.arpa'
    ngram_train.train_arpa(sents, str(ours), order=order, prune_count=prune)
    jax_ngram.train_arpa(sents, str(theirs), order=order, prune_count=prune)
    assert ours.read_bytes() == theirs.read_bytes()

    # Fuzzed sentences over the vocabulary and out-of-vocabulary words.
    probe = _corpus(rng, vocab + ['oov1', 'oov2'], 30)
    native, py = arpa_lm.ArpaLM(str(ours)), arpa_lm.PyArpaLM(str(ours))
    oracle = jax_lm.PyArpaLM(str(theirs))
    for sent in probe:
        for bos, eos in FLAGS:
            want = oracle.score(sent, bos=bos, eos=eos)
            assert abs(native.score(sent, bos=bos, eos=eos) - want) \
                <= SCORE_TOL
            assert abs(py.score(sent, bos=bos, eos=eos) - want) <= SCORE_TOL


def test_ngram_model_tables_match_jax():
    sents = ['the cat sat', 'the dog sat', 'a cat ran', 'the cat ran fast']
    ours = ngram_train.NgramLM(sents, order=3)
    theirs = jax_ngram.NgramLM(sents, order=3)
    assert ours.vocab == theirs.vocab
    assert ours.probs == theirs.probs
    assert ours.backoffs == theirs.backoffs
    with pytest.raises(ValueError, match='no training text'):
        ngram_train.NgramLM(['', '  '])


def test_load_lm_and_bad_files(tmp_path, fixture_paths):
    # kenlm is not installed here, so load_lm gives the C++ scorer.
    lm = arpa_lm.load_lm(fixture_paths['quirks'])
    assert isinstance(lm, arpa_lm.ArpaLM) and lm.order == 3
    with pytest.raises(ValueError, match='failed to load'):
        arpa_lm.ArpaLM(str(tmp_path / 'missing.arpa'))
    empty = tmp_path / 'empty.arpa'
    empty.write_text('\\data\\\n\\end\\\n')
    with pytest.raises(ValueError, match='failed to load'):
        arpa_lm.PyArpaLM(str(empty))
