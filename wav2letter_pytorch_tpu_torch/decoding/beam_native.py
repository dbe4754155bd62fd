"""ctypes wrapper of the host library's C++ prefix beam search
(``csrc/host/beam_search.cpp``).

The counterpart of ``wav2letter_pytorch_tpu.decoding.beam_native``: the
same semantics as ``decoder.prefix_beam_search``, run in C++ with the
ARPA scorer called in-process. The library is built at first use; a
failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import load_host


def native_available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        load_host()
    except (RuntimeError, OSError):
        return False
    return True


def prefix_beam_search_native(ctc, labels, blank_index: int = 0, lm=None,
                              k: int = 5, alpha: float = 0.3, beta: float = 5,
                              prune: float = 0.001, end_char: str = '>',
                              return_weights: bool = False, hotwords=None,
                              hotword_weight: float = 2.0):
    """C++ prefix beam search over [T, L] probabilities. ``lm`` must be
    None or an ``arpa_lm.ArpaLM``. ``hotwords``: words/phrases or a
    ``decoder.HotwordTrie``, with the Python search's semantics."""
    lib = load_host()
    ctc = np.ascontiguousarray(ctc, dtype=np.float32)
    if ctc.ndim != 2 or ctc.shape[1] != len(labels):
        raise ValueError(f'ctc shape {ctc.shape} does not match '
                         f'{len(labels)} labels')
    if ctc.shape[0] <= 1:
        raise ValueError(f'ctc length {ctc.shape[0]} is too short')
    if not (ctc >= 0).all():
        raise ValueError('ctc must be probabilities (non-negative)')

    lm_handle = None
    if lm is not None:
        from .arpa_lm import ArpaLM
        if not isinstance(lm, ArpaLM):
            raise TypeError('the C++ beam search needs an arpa_lm.ArpaLM '
                            '(or None); got ' + type(lm).__name__)
        lm_handle = lm._handle

    u32p = ctypes.POINTER(ctypes.c_uint32)
    hw_flat = hw_offs = None
    n_hw = 0
    if hotwords is not None:
        from .decoder import HotwordTrie
        trie = hotwords if isinstance(hotwords, HotwordTrie) \
            else HotwordTrie(hotwords, hotword_weight)
        hotword_weight = trie.weight
        words = sorted(trie.words)
        n_hw = len(words)
        hw_flat = np.array([ord(c) for w in words for c in w] or [0],
                           dtype=np.uint32)
        hw_offs = np.zeros(n_hw + 1, dtype=np.int64)
        np.cumsum([len(w) for w in words], out=hw_offs[1:])

    label_codes = np.array([ord(c) for c in labels], dtype=np.uint32)
    T, L = ctc.shape
    out_cap = T + 8
    out_buf = np.zeros(out_cap, dtype=np.uint32)
    score = ctypes.c_double(0.0)
    n = lib.w2l_prefix_beam_search(
        ctc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, L,
        label_codes.ctypes.data_as(u32p), blank_index, lm_handle, k, alpha,
        beta, prune, ord(end_char),
        None if hw_flat is None else hw_flat.ctypes.data_as(u32p),
        None if hw_offs is None
        else hw_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_hw, hotword_weight, out_buf.ctypes.data_as(u32p), out_cap,
        ctypes.byref(score))
    decoded = ''.join(chr(c) for c in out_buf[:n])
    if return_weights:
        return decoded, score.value
    return decoded
