"""The port's batched device beam search (torch ops, run here on the CPU) vs
the JAX package's ``beam_device`` on the CPU, on the same log-probs.

String-exact: ``beam_search_device`` (n-best strings, and its scores
within float32 rounding), ``beam_search_device_lm`` with a callable LM,
hotwords and both, and ``DeviceBeamDecoder`` in its fused and rescore LM
modes; each also against the host DP. A tie case pins the top-k order:
``torch.topk`` breaks ties another way than ``jax.lax.top_k`` and changes
the string there.
"""

import numpy as np
import pytest
import torch

from wav2letter_pytorch_tpu.decoding import beam_device as jbd
from wav2letter_pytorch_tpu.decoding import decoder as jdec
from wav2letter_pytorch_tpu.decoding import ngram_train as jax_ngram
from wav2letter_pytorch_tpu_torch.decoding import beam_device as pbd
from wav2letter_pytorch_tpu_torch.decoding import decoder as pdec

torch.set_num_threads(1)

LABELS = list("_'abcdefghijklmnopqrstuvwxyz ")
V = len(LABELS)
B, T = 3, 24
LENGTHS = np.array([24, 17, 9])
WORDS = ['the', 'cat', 'sat', 'on', 'a', 'mat', 'dog', 'ran']
# n-best log scores: float32 log-space sums of T terms on both sides, in
# another order of the same operations.
SCORE_RTOL = 1e-5


def _random_probs(rng, T, V, peaky=True):
    logits = rng.standard_normal((T, V)) * (3.0 if peaky else 1.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _batch(seed, peaky=True):
    rng = np.random.default_rng(seed)
    probs = np.stack([_random_probs(rng, T, V, peaky) for _ in range(B)])
    return probs, np.log(probs).astype(np.float32)


def _strings(results):
    return [[''.join(LABELS[i] for i in h[0]) for h in hyps]
            for hyps in results]


def _lm(s):
    return 0.3 ** len(s.split()) * (2.0 if 'a' in s else 1.0)


@pytest.fixture(scope='module')
def lm_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    sents = [' '.join(rng.choice(WORDS, size=int(rng.integers(2, 6))))
             for _ in range(50)]
    path = tmp_path_factory.mktemp('lm') / 'lm.arpa'
    jax_ngram.train_arpa(sents, str(path), order=3)
    return str(path)


def test_hash_multiply_wraps_as_uint32():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, size=1000, dtype=np.uint64)
    h[:3] = [0, 1, 2 ** 32 - 1]
    for mult in (pbd._H1_MULT, pbd._H2_MULT):
        want = h.astype(np.uint32) * np.uint32(mult)
        got = pbd._mul32(torch.from_numpy(h.astype(np.int64)), mult)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize('seed,peaky,k,beta,prune',
                         [(0, True, 5, 5.0, 1e-3), (1, False, 3, 0.0, 1e-2),
                          (2, True, 8, 2.0, 1e-3)])
def test_search_matches_jax_and_host(seed, peaky, k, beta, prune):
    probs, lp = _batch(seed, peaky)
    kw = dict(k=k, beta=beta, prune=prune, n_best=k)
    ours = pbd.beam_search_device(lp, LENGTHS, LABELS, **kw)
    theirs = jbd.beam_search_device(lp, LENGTHS, LABELS, **kw)
    assert _strings(ours) == _strings(theirs)
    for a, b in zip(ours, theirs):
        for (_, s1, r1), (_, s2, r2) in zip(a, b):
            assert s1 == pytest.approx(s2, rel=SCORE_RTOL)
            assert r1 == pytest.approx(r2, rel=SCORE_RTOL)
    for b in range(B):
        assert _strings(ours)[b][0] == jdec.prefix_beam_search(
            probs[b, :LENGTHS[b]], LABELS, k=k, beta=beta, prune=prune)
    # a tensor input is searched where it lies, with the same answer
    assert pbd.beam_search_device(torch.from_numpy(lp),
                                  torch.from_numpy(LENGTHS), LABELS,
                                  **kw) == ours


@pytest.mark.parametrize('use_lm,hotwords', [(True, None),
                                             (False, ['at', 'the']),
                                             (True, ['cat', 'mat'])])
def test_fused_lm_and_hotwords_match_jax_and_host(use_lm, hotwords):
    probs, lp = _batch(3)
    lm = _lm if use_lm else None
    kw = dict(k=5, alpha=0.5, beta=1.0, prune=1e-3, hotwords=hotwords)
    ours = pbd.beam_search_device_lm(lp, LENGTHS, LABELS, lm, **kw)
    assert ours == jbd.beam_search_device_lm(lp, LENGTHS, LABELS, lm, **kw)
    assert ours == [jdec.prefix_beam_search(probs[b, :LENGTHS[b]], LABELS,
                                            lm=lm, **kw) for b in range(B)]


@pytest.mark.parametrize('lm_mode', ['fused', 'rescore'])
def test_decoder_matches_jax(lm_path, lm_mode):
    probs, _ = _batch(4)
    kw = dict(k=6, alpha=0.8, beta=1.0, lm_path=lm_path, lm_mode=lm_mode)
    ours = pbd.DeviceBeamDecoder(LABELS, device='cpu', **kw)
    theirs = jbd.DeviceBeamDecoder(LABELS, **kw)
    got, got_off = ours.decode(probs, LENGTHS, return_offsets=True)
    want, want_off = theirs.decode(probs, LENGTHS, return_offsets=True)
    assert got == want
    for a, b in zip(got_off, want_off):
        np.testing.assert_array_equal(a, b)
    assert ours.decode(probs[0]) == theirs.decode(probs[0])
    if lm_mode == 'fused':
        host = pdec.PrefixBeamSearchLMDecoder(lm_path, LABELS, k=6,
                                              alpha=0.8, beta=1.0)
        assert got == host.decode(probs, LENGTHS)
        hw = pbd.DeviceBeamDecoder(LABELS, device='cpu', hotwords=['cat'],
                                   **kw)
        assert hw.decode(probs, LENGTHS) == jbd.DeviceBeamDecoder(
            LABELS, hotwords=['cat'], **kw).decode(probs, LENGTHS)
    else:
        with pytest.raises(ValueError, match='in-loop fusion'):
            pbd.DeviceBeamDecoder(LABELS, device='cpu', hotwords=['cat'],
                                  **kw)


@pytest.mark.parametrize('seed,k', [(0, 1), (4, 2), (10, 3)])
def test_ties_go_to_the_lower_index(seed, k, monkeypatch):
    """The two likeliest non-blank chars of frame 0 share their mass
    exactly, and the k-th beam falls between their prefixes at the next
    step: JAX's top_k keeps the lower label index, and so must the port.
    ``torch.topk`` keeps the other one here, and the string changes."""
    rng = np.random.default_rng(seed)
    probs = _random_probs(rng, 8, V)
    c1, c2 = (np.argsort(-probs[0, 1:]) + 1)[:2]
    probs[0, c1] = probs[0, c2] = (probs[0, c1] + probs[0, c2]) / 2
    lp = np.log(probs).astype(np.float32)[None]
    kw = dict(k=k, beta=0.0)
    want = _strings(jbd.beam_search_device(lp, [8], LABELS, **kw))
    assert _strings(pbd.beam_search_device(lp, [8], LABELS, **kw)) == want
    assert want[0][0] == jdec.prefix_beam_search(probs, LABELS, **kw)
    monkeypatch.setattr(pbd, '_top_k',
                        lambda x, k: torch.topk(x, k, dim=-1)[1])
    assert _strings(pbd.beam_search_device(lp, [8], LABELS, **kw)) != want


def test_errors(monkeypatch):
    _, lp = _batch(0)
    with pytest.raises(ValueError, match='end_char'):
        pbd.beam_search_device(lp, LENGTHS, LABELS[:-1] + ['>'])
    with pytest.raises(ValueError, match='lm_mode'):
        pbd.DeviceBeamDecoder(LABELS, device='cpu', lm_mode='other')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pbd.DeviceBeamDecoder(LABELS)
