"""CTC forced alignment: per-character/word times for a KNOWN transcript.

The counterpart of ``wav2letter_pytorch_tpu.decoding.forced_align``, on
numpy as there. Viterbi over the CTC lattice: the target ``y`` (S chars)
expands to the blank-interleaved state chain ``z = [_, y1, _, y2, ..., yS,
_]`` (2S+1 states); the best monotone state path under the model's
per-frame log-probabilities assigns every character its frame span. Beam
decoders use it for the offsets of their hypotheses (``--word-timings``).

Host-side numpy: the lattice is [T, 2S+1] — tiny next to the acoustic
forward, and alignment is an offline tool, not the serving hot path.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -np.inf


def forced_align(log_probs, text: str, labels, blank_index: int = 0):
    """Viterbi-align ``text`` to per-frame ``log_probs`` [T, L].

    Returns ``[(char, start_frame, end_frame_exclusive), ...]`` covering
    every character of ``text`` (blanks absorbed into no span). Raises if
    the transcript cannot be emitted in T frames (too short) or contains
    characters outside ``labels``.
    """
    lp = np.asarray(log_probs, np.float64)
    assert lp.ndim == 2, f'expected [T, L], got {lp.shape}'
    T, L = lp.shape
    assert L == len(labels), f'width {L} != len(labels) {len(labels)}'
    char_ix = {c: i for i, c in enumerate(labels)}
    try:
        y = [char_ix[c] for c in text]
    except KeyError as e:
        raise ValueError(f'transcript char {e.args[0]!r} not in labels')
    S = len(y)
    if S == 0:
        return []
    # CTC length feasibility: repeats need a separating blank.
    min_frames = S + sum(1 for a, b in zip(y, y[1:]) if a == b)
    if T < min_frames:
        raise ValueError(f'{T} frames cannot emit {S} chars '
                         f'(needs >= {min_frames})')

    n = 2 * S + 1
    z = np.full(n, blank_index, np.int64)
    z[1::2] = y
    # allow_skip[s]: path may jump s-2 -> s (z[s] non-blank, differs from
    # z[s-2])
    allow_skip = np.zeros(n, bool)
    allow_skip[3::2] = z[3::2] != z[1:-2:2]

    emit = lp[:, z]                                   # [T, n]
    delta = np.full(n, NEG_INF)
    delta[0] = emit[0, 0]
    if n > 1:
        delta[1] = emit[0, 1]
    back = np.zeros((T, n), np.int8)                  # 0: stay, 1: -1, 2: -2
    for t in range(1, T):
        stay = delta
        prev1 = np.concatenate(([NEG_INF], delta[:-1]))
        prev2 = np.concatenate(([NEG_INF, NEG_INF], delta[:-2]))
        prev2 = np.where(allow_skip, prev2, NEG_INF)
        choices = np.stack([stay, prev1, prev2])      # [3, n]
        arg = np.argmax(choices, axis=0)
        back[t] = arg
        delta = choices[arg, np.arange(n)] + emit[t]

    # Terminal state: last blank or last char, whichever scored higher.
    s = n - 1 if delta[n - 1] >= delta[n - 2] else n - 2
    if not np.isfinite(delta[s]):
        raise ValueError('no feasible alignment path')
    path = np.zeros(T, np.int64)
    for t in range(T - 1, -1, -1):
        path[t] = s
        s -= int(back[t, s])
    assert path[0] in (0, 1), 'path must start at the first blank or char'

    spans = []
    for ci in range(S):
        state = 2 * ci + 1
        frames = np.nonzero(path == state)[0]
        spans.append((text[ci], int(frames[0]), int(frames[-1]) + 1))
    return spans


def word_alignments(log_probs, text: str, labels, blank_index: int = 0,
                    frame_seconds: float = 1.0):
    """``[(word, start_s, end_s), ...]`` for a known transcript.

    The span of a word runs from its first character's first frame to its
    last character's last frame, scaled by ``frame_seconds``
    (= window_stride x the model's conv scaling factor, the same ratio
    get_time_per_word uses).
    """
    spans = forced_align(log_probs, text, labels, blank_index)
    words = []
    start = end = None
    chars = []
    for c, s, e in spans:
        if c == ' ':
            if chars:
                words.append((''.join(chars), start * frame_seconds,
                              end * frame_seconds))
            chars, start = [], None
            continue
        if not chars:
            start = s
        chars.append(c)
        end = e
    if chars:
        words.append((''.join(chars), start * frame_seconds,
                      end * frame_seconds))
    return words
