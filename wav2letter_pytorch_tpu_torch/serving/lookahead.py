"""Bounded-lookahead streaming: commit outputs after <= K frames of future.

The counterpart of the JAX package's ``serving/lookahead.py``. The
exact-parity streamer (``streaming.py``) emits an output frame only once
its full receptive field has arrived; the symmetric SAME padding of these
stacks makes half of it future context (4.2 s for Wav2Letter-20, ~40 s for
QuartzNet-15x5). This streamer trades a bounded deviation for bounded
latency: outputs are emitted once ``lookahead_frames`` of real future
context exist. Each emission re-runs the model (the port's eval-mode
``Wav2Letter`` or ``Jasper``: on the card, Jasper's forward launches K4
once and K6 once a unit) over a fixed window

    [ left_frames | chunk_frames | lookahead_frames ]

of streamed, normalised feature frames and commits the rows over the
chunk. ``left_frames`` defaults to the model's full one-sided receptive
field, so an emitted frame's past context is exact; only context beyond
``lookahead_frames`` in the future is replaced by the window's SAME
padding. The features come from the exact streamer's frontend phases
(``_FrontendStreaming``, K1 once a chunk), so the feature sequence is the
exact streamer's. Wav2Letter windows give log-probs, Jasper windows
probabilities (each model's eval output).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import compute_new_kernel_size
from .streaming import _FrontendStreaming


def _conv_specs_w2l(layers):
    """(kernel, stride, dilation) per conv of a Wav2Letter stack."""
    return [(int(l['kernel_size']), int(l.get('stride', 1)),
             int(l.get('dilation', 1))) for l in layers]


def _conv_specs_jasper(blocks):
    """(kernel, stride, dilation) per main-chain conv of a Jasper encoder
    (residual 1x1 branches add no temporal context)."""
    out = []
    for b in blocks:
        k = compute_new_kernel_size(int(b['kernel_size']),
                                    float(b.get('kernel_size_factor', 1.0)))
        s = int(b.get('stride', 1))
        d = int(b.get('dilation', 1))
        for r in range(int(b.get('repeat', 1))):
            out.append((k, s if r == 0 else 1, d))
    return out


def one_sided_context(conv_specs) -> int:
    """Input frames of one-sided (future) context of a SAME-padded conv
    stack -- the exact streamer's lookahead recurrence."""
    la = 0
    for k, s, d in reversed(conv_specs):
        pad = max(0, (k - 1) * d + 1 - s)
        ctx = (k - 1) * d + 1 - s          # context beyond the stride
        la = la * s + (ctx - pad // 2)
    return la


class BoundedLookaheadStreamer(_FrontendStreaming):
    """Windowed re-compute streamer with bounded future context.

    Parameters
    ----------
    model : the port's ``Wav2Letter`` or ``Jasper`` (weights loaded), run
        in eval mode on ``device``.
    frontend : the offline ``SpectrogramFrontend`` (streaming numerics).
    conv_specs : [(kernel, stride, dilation)] of the conv stack --
        ``_conv_specs_w2l(layers[:mid])`` or
        ``_conv_specs_jasper(jasper_blocks[:mid])``.
    chunk_frames : emission cadence in feature frames (a multiple of the
        model's total stride).
    lookahead_frames : real future feature frames required before a chunk
        is committed (a multiple of the total stride): the latency knob.
    left_frames : past context in the window (default: the stack's full
        one-sided receptive field, so past context is exact).
    extrap_frames / extrap_mode : extend each mid-stream window to the
        right with ``extrap_frames`` synthesized future frames ('reflect'
        mirrors the real tail, 'repeat' holds the last frame) before the
        model's SAME padding zero-fills beyond the window. The final window
        at finish() keeps plain zero padding.
    norm / norm_stats : as in the exact streamer ('cumulative' default).
    device : where the frontend phases and the model run (default the
        card).
    """

    def __init__(self, model, frontend, conv_specs, chunk_frames: int = 64,
                 lookahead_frames: int = 96, left_frames: int | None = None,
                 norm: str = 'cumulative', norm_stats=None,
                 extrap_frames: int = 0, extrap_mode: str = 'reflect',
                 device='cuda'):
        self._init_frontend(frontend, norm, norm_stats, chunk_frames, device)
        self.scale = int(model.scaling_factor)
        if chunk_frames % self.scale or lookahead_frames % self.scale:
            raise ValueError('chunk_frames and lookahead_frames must be '
                             f'multiples of the total stride {self.scale}')
        rf = one_sided_context(conv_specs)
        if left_frames is None:
            left_frames = -(-rf // self.scale) * self.scale
        if left_frames % self.scale:
            raise ValueError('left_frames must be a multiple of the total '
                             f'stride {self.scale}')
        self.left_frames = left_frames
        self.lookahead_frames = lookahead_frames
        if extrap_mode not in ('reflect', 'repeat'):
            raise ValueError(f'unknown extrap_mode {extrap_mode!r}')
        self.extrap_frames = int(extrap_frames)
        self.extrap_mode = extrap_mode
        # real (streamed) frames per window; the model sees real + extrap.
        self.real_window_frames = (left_frames + chunk_frames
                                   + lookahead_frames)
        if not 0 <= self.extrap_frames < self.real_window_frames:
            raise ValueError('extrap_frames must be < left+chunk+lookahead')
        self.window_frames = self.real_window_frames + self.extrap_frames
        self.model = model.to(self.device).eval()
        head = model.conv1ds[-1].conv1 if hasattr(model, 'conv1ds') \
            else model.final_layer[0]
        self.num_labels = int(head.out_channels)
        self.emits_probs = bool(getattr(model, 'eval_emits_probs', False))

        # Frontend steady-state carry length (prime consumes what it can;
        # the remainder carries) -- the finish phase's geometry needs it.
        n0 = (self.n_fft // 2 + self.chunk_samples - self.n_fft) \
            // self.hop + 1
        self._set_fin_zeros(self.n_fft // 2 + self.chunk_samples
                            - n0 * self.hop)
        self._win_len = torch.full((1,), self.window_frames,
                                   dtype=torch.int32, device=self.device)
        self._prime_fn = torch.no_grad()(self._fe_prime)
        self._step_fn = torch.no_grad()(self._fe_step)
        self._finish_fn = torch.no_grad()(self._fe_finish)

    @torch.no_grad()
    def _win_fn(self, feats):
        """The model over one window ``[1, W, M]``: its eval output
        ``[1, W / scale, L]`` (log-probs, or Jasper's probabilities)."""
        out, _ = self.model(feats, self._win_len)
        return out

    def start(self) -> 'BoundedLookaheadSession':
        return BoundedLookaheadSession(self)


class BoundedLookaheadSession:
    """Audio in, committed model-output rows out (never revised). The
    features stay on the streamer's device; committed rows come back as
    numpy."""

    def __init__(self, m: BoundedLookaheadStreamer):
        self.m = m
        self._audio = np.zeros((1, 0), np.float32)
        self._fe_state = None           # (preemph_last, fe_carry, norm_state)
        self._feats = torch.zeros((1, 0, m.feat_dim), device=m.device)
        self._emitted = 0               # feature frames committed
        self._consumed = 0              # samples through the frontend
        self._finished = False

    # -- internal ---------------------------------------------------------
    def _pump_frontend(self):
        m = self.m
        outs = []
        while self._audio.shape[1] >= m.chunk_samples:
            chunk = torch.from_numpy(self._audio[:, :m.chunk_samples]).to(
                m.device)
            self._audio = self._audio[:, m.chunk_samples:]
            if self._fe_state is None:
                pl_, carry, nstate, feats = m._prime_fn(chunk)
            else:
                pl_, carry, nstate, feats = m._step_fn(*self._fe_state,
                                                       chunk)
            self._fe_state = (pl_, carry, nstate)
            self._consumed += m.chunk_samples
            outs.append(feats)
        if outs:
            self._feats = torch.cat([self._feats] + outs, dim=1)

    def _window(self, upto: int):
        """Real feature window [1, left+chunk+la, M] ending at feature
        frame ``upto`` (exclusive), left-zero-padded at stream start."""
        m = self.m
        lo = upto - m.real_window_frames
        if lo >= 0:
            return self._feats[:, lo:upto]
        pad = self._feats.new_zeros((1, -lo, m.feat_dim))
        return torch.cat([pad, self._feats[:, :upto]], dim=1)

    def _extend(self, win):
        """Append ``extrap_frames`` synthesized future frames (mid-stream
        windows only; finish() zero-pads instead -- the stream has ended)."""
        m = self.m
        e = m.extrap_frames
        if not e:
            return win
        W = win.shape[1]
        if m.extrap_mode == 'repeat':
            tail = win[:, -1:].expand(-1, e, -1)
        else:  # reflect about the last real frame
            tail = win[:, W - 1 - e:W - 1].flip(1)
        return torch.cat([win, tail], dim=1)

    def _emit_ready(self):
        m = self.m
        outs = []
        while (self._feats.shape[1]
               >= self._emitted + m.chunk_frames + m.lookahead_frames):
            upto = self._emitted + m.chunk_frames + m.lookahead_frames
            out = m._win_fn(self._extend(self._window(upto)))
            s, c = m.left_frames // m.scale, m.chunk_frames // m.scale
            outs.append(out[:, s:s + c].cpu().numpy())
            self._emitted += m.chunk_frames
        return outs

    # -- public -----------------------------------------------------------
    def feed(self, audio) -> np.ndarray:
        """Append raw audio [n] or [1, n]; returns newly committed model
        output rows [1, m, L] (m may be 0 while context accumulates)."""
        if self._finished:
            raise RuntimeError('session already finished')
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        self._audio = np.concatenate([self._audio, audio], axis=1)
        self._pump_frontend()
        outs = self._emit_ready()
        if not outs:
            return np.zeros((1, 0, self.m.num_labels), np.float32)
        return np.concatenate(outs, axis=1)

    def finish(self) -> np.ndarray:
        """Flush: drain the frontend tail, then emit the remaining rows
        from a final right-zero-padded window. Returns the tail output
        rows [1, m, L] (feed() emissions plus this = the full utterance,
        total rows = total_feature_frames // scale)."""
        if self._finished:
            raise RuntimeError('session already finished')
        self._finished = True
        m = self.m
        total_len = self._consumed + self._audio.shape[1]
        if self._fe_state is None:
            # Stream shorter than one frontend chunk: prime on the padded
            # buffer, then treat everything as tail feature frames.
            buf = np.zeros((1, m.chunk_samples), np.float32)
            buf[:, :self._audio.shape[1]] = self._audio
            pl_, carry, nstate, feats = m._prime_fn(
                torch.from_numpy(buf).to(m.device))
            self._fe_state = (pl_, carry, nstate)
            # offline framing yields 1 + L//hop frames for true length L
            n_valid = max(0, min(total_len // m.hop + 1, feats.shape[1]))
            self._feats = feats[:, :n_valid]
        else:
            tail_len = total_len - self._consumed
            tail = np.zeros((1, m.chunk_samples), np.float32)
            if self._audio.shape[1]:
                tail[:, :self._audio.shape[1]] = self._audio
            feats, valid = m._finish_fn(
                *self._fe_state, torch.from_numpy(tail).to(m.device),
                torch.tensor([tail_len], dtype=torch.int64, device=m.device))
            self._feats = torch.cat(
                [self._feats, feats[:, :int(valid[0])]], dim=1)
        outs = self._emit_ready()
        total_rows = self._feats.shape[1] // m.scale
        rem_rows = total_rows - self._emitted // m.scale
        if rem_rows > 0:
            # final partial window, right side zero-padded (the same class
            # of deviation as the bounded lookahead itself)
            upto = self._emitted + m.chunk_frames + m.lookahead_frames
            window = self._window(upto)
            if window.shape[1] < m.window_frames:
                # the future that never arrived: zero-pad right to W
                pad = window.new_zeros((1, m.window_frames - window.shape[1],
                                        m.feat_dim))
                window = torch.cat([window, pad], dim=1)
            out = m._win_fn(window)
            s = m.left_frames // m.scale
            outs.append(out[:, s:s + rem_rows].cpu().numpy())
            self._emitted += rem_rows * m.scale
        if not outs:
            return np.zeros((1, 0, m.num_labels), np.float32)
        return np.concatenate(outs, axis=1)


def bounded_stream_logprobs(streamer: BoundedLookaheadStreamer, audio,
                            feed_samples: int | None = None) -> np.ndarray:
    """Run one utterance [1, n] through a fresh session in feed-sized
    pieces and return the full committed output [1, T_out, L]."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    step = feed_samples or streamer.chunk_samples
    sess = streamer.start()
    outs = []
    for off in range(0, audio.shape[1], step):
        outs.append(sess.feed(audio[:, off:off + step]))
    outs.append(sess.finish())
    return np.concatenate([o for o in outs if o.shape[1]], axis=1)
