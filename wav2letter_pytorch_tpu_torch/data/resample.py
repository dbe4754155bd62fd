"""Rational-ratio polyphase sample-rate conversion (numpy).

The counterpart of the JAX package's ``data/resample.py``, kept as the
port's own copy so the port imports nothing of that package; the same
inputs give the same bits. The streaming server (``serving/net.py``)
converts clients at another rate with ``StreamingResampler``.

Design (the standard ``upfirdn`` formulation):

* reduce ``target/orig`` to ``up/down`` with ``fractions.Fraction`` --
  exact for every pair of standard audio rates (44100/16000 = 160/441);
* design one linear-phase FIR low-pass at the up-sampled rate with cutoff
  ``min(1/up, 1/down)`` (normalized to Nyquist) and a Kaiser window --
  the parameterization scipy's ``resample_poly`` defaults to (half-length
  ``10*max(up, down)`` taps, beta 5.0, ~60 dB stop-band);
* evaluate only the needed output samples through the filter's ``up``
  polyphase components (one ``np.convolve`` per phase), never
  materializing the zero-stuffed signal;
* align the filter's group delay so ``y[0]`` corresponds to ``x[0]``
  (output ``n`` sits at input time ``n * down / up``).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

# Kaiser beta 5.0 ~= 60 dB stop-band attenuation; half-length 10 zero
# crossings per polyphase branch. Matches scipy.signal.resample_poly's
# default ('kaiser', 5.0) quality point.
_KAISER_BETA = 5.0
_HALF_ZEROS = 10


def design_lowpass(up: int, down: int) -> np.ndarray:
    """Linear-phase Kaiser-windowed-sinc low-pass for an up/down resampler.

    Operates at the up-sampled rate: cutoff ``1/max(up, down)`` of that
    Nyquist, unit DC gain, then scaled by ``up`` to preserve signal level
    through zero-stuffing.
    """
    max_rate = max(up, down)
    half = _HALF_ZEROS * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    fc = 1.0 / max_rate  # relative to Nyquist at the up-sampled rate
    h = fc * np.sinc(fc * n)
    h *= np.kaiser(2 * half + 1, _KAISER_BETA)
    h /= h.sum()  # unit DC gain
    return (h * up).astype(np.float64)


def resample_ratio(orig_rate: int, target_rate: int) -> tuple[int, int]:
    """(up, down) in lowest terms for orig -> target conversion."""
    frac = Fraction(int(target_rate), int(orig_rate))
    return frac.numerator, frac.denominator


def resample(x: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Resample mono float audio from ``orig_rate`` to ``target_rate``.

    Returns float32 of length ``ceil(len(x) * target / orig)``; the input
    is treated as zero outside its support (same edge convention as
    scipy's ``resample_poly(padtype='constant')``).
    """
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError(f'expected mono 1-D audio, got shape {x.shape}')
    if int(orig_rate) == int(target_rate) or x.size == 0:
        return x.astype(np.float32)
    up, down = resample_ratio(orig_rate, target_rate)
    h = design_lowpass(up, down)
    n_in = len(x)
    n_out = -(-n_in * up // down)  # ceil

    # Output n taps the up-sampled-domain convolution at j = offset + n*down,
    # where offset centers the filter (group delay (L-1)/2). Polyphase: with
    # r = j % up and q = j // up,  y[n] = sum_k h[r + k*up] * x[q - k]
    #                                   = convolve(x, h[r::up])[q].
    offset = (len(h) - 1) // 2
    j = offset + np.arange(n_out, dtype=np.int64) * down
    r = (j % up).astype(np.int64)
    q = (j // up).astype(np.int64)

    y = np.zeros(n_out, np.float64)
    for phase in range(min(up, n_out)):
        sel = r == phase
        if not sel.any():
            continue
        taps = h[phase::up]
        c = np.convolve(x, taps)  # c[i] = sum_k taps[k] * x[i-k]
        qi = q[sel]
        valid = qi < len(c)  # beyond the tail the (zero-padded) conv is 0
        out = np.zeros(qi.shape, np.float64)
        out[valid] = c[qi[valid]]
        y[sel] = out
    return y.astype(np.float32)


class StreamingResampler:
    """Chunk-wise rate conversion with state carried between pushes.

    Produces the exact samples of the one-shot ``resample`` on the
    concatenated input, regardless of how the stream is chunked — so a
    serving front door can accept 8/44.1/48 kHz clients against a 16 kHz
    model with zero train/serve skew. Output ``n`` taps input through
    sample ``(offset + n*down) // up`` (the filter's look-ahead,
    ~``10 * max(1, orig/target)`` input samples), so each push emits every
    output computable so far and ``flush()`` emits the zero-padded tail.
    """

    def __init__(self, orig_rate: int, target_rate: int):
        self.orig_rate = int(orig_rate)
        self.target_rate = int(target_rate)
        self.identity = self.orig_rate == self.target_rate
        if self.identity:
            return
        self.up, self.down = resample_ratio(orig_rate, target_rate)
        self._h = design_lowpass(self.up, self.down)
        self._phases = [self._h[p::self.up] for p in range(self.up)]
        self._hist = max(len(t) for t in self._phases) - 1  # past taps
        self._offset = (len(self._h) - 1) // 2
        self._buf = np.zeros(0, np.float64)  # last _hist input samples
        self._n_in = 0   # total input samples consumed
        self._n_out = 0  # total output samples emitted

    def _emit(self, upto_q: int) -> np.ndarray:
        """Emit outputs whose newest input index q is < upto_q."""
        # q(n) = (offset + n*down) // up < upto_q  ⇔  n < n_ready
        n_ready = max((upto_q * self.up - self._offset + self.down - 1)
                      // self.down, 0)
        if n_ready <= self._n_out:
            return np.zeros(0, np.float32)
        ns = np.arange(self._n_out, n_ready, dtype=np.int64)
        j = self._offset + ns * self.down
        r = j % self.up
        q = j // self.up
        # self._buf holds input samples [base, n_avail): everything an
        # output here can touch (q - hist .. q).
        base = self._n_in - len(self._buf)
        y = np.empty(len(ns), np.float64)
        for phase in set(r.tolist()):
            sel = r == phase
            taps = self._phases[phase]
            c = np.convolve(self._buf, taps)
            ci = q[sel] - base
            y[sel] = c[ci]
        # conv of the buffer alone misses contributions of samples older
        # than base — impossible by construction: q - (len(taps)-1) >= base
        # for every emitted n (buf keeps _hist = max_taps-1 history).
        self._n_out = int(n_ready)
        return y.astype(np.float32)

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed a chunk; returns every newly computable output sample."""
        samples = np.asarray(samples, np.float64).reshape(-1)
        if self.identity:
            return samples.astype(np.float32)
        self._buf = np.concatenate([self._buf, samples])
        self._n_in += len(samples)
        out = self._emit(self._n_in)
        keep = self._hist + (self._offset // self.up) + 1
        if len(self._buf) > keep:
            self._buf = self._buf[-keep:]
        return out

    def flush(self) -> np.ndarray:
        """End of stream: emit the remaining look-ahead tail so the total
        output length equals ``ceil(n_in * up / down)`` (one-shot parity)."""
        if self.identity:
            return np.zeros(0, np.float32)
        n_total = -(-self._n_in * self.up // self.down)
        if n_total <= self._n_out:
            return np.zeros(0, np.float32)
        # Zero-pad far enough that every remaining output's window closes.
        pad = self._offset // self.up + self.down // self.up + 2
        self._buf = np.concatenate([self._buf, np.zeros(pad, np.float64)])
        self._n_in += pad
        out = self._emit(self._n_in)
        # The padding can over-run past n_total; clamp to one-shot length.
        extra = self._n_out - n_total
        if extra > 0:
            out = out[:len(out) - extra]
            self._n_out = n_total
        return out
