"""Edit distance over the port's host library (``csrc/host/levenshtein.cpp``).

Same functions as ``wav2letter_pytorch_tpu.decoding.levenshtein``:
``distance`` and ``batch_distance`` run in C++ on 32-bit code points (WER
maps words to integer ids first), ``align`` is a numpy backtrace for error
analysis, and ``_py_distance`` is the plain-Python Wagner-Fischer the tests
hold the library against. The library is built at first use
(``_build.load_host``); a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import load_host

_U32P = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _py_distance(a, b) -> int:
    """Wagner-Fischer with two rolling rows."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        curr = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            curr[j] = min(prev[j] + 1, curr[j - 1] + 1,
                          prev[j - 1] + (ca != cb))
        prev = curr
    return prev[-1]


def _to_u32(seq) -> np.ndarray:
    if isinstance(seq, str):
        return np.frombuffer(seq.encode('utf-32-le'), dtype=np.uint32)
    return np.asarray(seq, dtype=np.uint32)


def distance(a, b) -> int:
    """Levenshtein distance between two strings or integer sequences."""
    lib = load_host()
    ua, ub = _to_u32(a), _to_u32(b)
    return int(lib.w2l_levenshtein_u32(ua.ctypes.data_as(_U32P), len(ua),
                                       ub.ctypes.data_as(_U32P), len(ub)))


def batch_distance(pairs) -> list[int]:
    """Distances for many (a, b) pairs with a single library call."""
    lib = load_host()
    a_arrs = [_to_u32(a) for a, _ in pairs]
    b_arrs = [_to_u32(b) for _, b in pairs]
    a_off = np.zeros(len(pairs) + 1, dtype=np.int64)
    b_off = np.zeros(len(pairs) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in a_arrs], out=a_off[1:])
    np.cumsum([len(x) for x in b_arrs], out=b_off[1:])
    # At least one element each, so the pointers are valid.
    a_flat = np.concatenate(a_arrs + [np.zeros(1, np.uint32)])
    b_flat = np.concatenate(b_arrs + [np.zeros(1, np.uint32)])
    out = np.zeros(len(pairs), dtype=np.int64)
    lib.w2l_levenshtein_u32_batch(
        a_flat.ctypes.data_as(_U32P), a_off.ctypes.data_as(_I64P),
        b_flat.ctypes.data_as(_U32P), b_off.ctypes.data_as(_I64P),
        len(pairs), out.ctypes.data_as(_I64P))
    return out.tolist()


def align(ref, hyp):
    """Minimum-edit alignment of two token sequences.

    Returns ``[(op, ref_tok, hyp_tok), ...]`` with op in
    {'ok', 'sub', 'del', 'ins'} (the absent side is None); the number of
    non-'ok' entries equals :func:`distance`.
    """
    ref, hyp = list(ref), list(hyp)
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), dtype=np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]))
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] \
                and ref[i - 1] == hyp[j - 1]:
            ops.append(('ok', ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            ops.append(('sub', ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            ops.append(('del', ref[i - 1], None))
            i -= 1
        else:
            ops.append(('ins', None, hyp[j - 1]))
            j -= 1
    return ops[::-1]
