"""Streaming (chunked, stateful) inference for Wav2Letter, on the card.

The counterpart of the JAX package's ``serving/streaming.py``. Audio comes
in fixed chunks; three phases (prime, step, finish) run over tensors on
the streamer's device, and every cross-chunk dependency is carried in
state tensors of fixed shape with the batch leading (``StreamState``).

Semantics: exact offline equivalence. With fixed normalisation statistics
(``norm='precomputed'``, corpus CMVN) the emitted log-probs equal the
offline pipeline's (``SpectrogramFrontend`` -> the eval-mode
``Wav2Letter``) on the same audio zero-padded to an even frame length at
least the utterance's plus the network's lookahead, up to float
reassociation. ``norm='cumulative'`` normalises with running statistics
over the frames seen so far instead.

Mechanics: each conv layer, and the STFT framing (a stride-``hop``
width-``n_fft`` conv), keeps a carry of its last inputs at its own frame
rate. Carry lengths, the prime window and the finish flush are solved
once at construction (``_plan``). The stream start replicates the offline
left reflect pad; the finish replicates the frontend's right reflect pad
at each row's true end and flushes the conv lookahead over zero features.

Every phase launches kernel K1 (``ops/stft_mel.py``) once, for the
framing, window, DFT, power, mel and log of its new frames: a contiguous
float32 buffer of carried plus new samples. An MFCC frontend's DCT
follows K1 (a plain product, as in the offline frontend). The conv stack keeps its
activations and carries in ``[B, C, T]``, the layout ``F.conv1d`` takes,
so a step transposes nothing a layer; ``weights='int8_full'`` works in
``[B, T, C]`` as ``serving/infer.py`` does, with a VALID im2col times
``torch._int_mm`` (``infer.conv_q8_valid``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.features import NORM_EPS, PREEMPH
from ..runtime import resolve_device
from .fold import fold_batchnorm
from .infer import (ACT_CLAMP, _materialize, conv_q8_valid,
                    dynamic_act_scale, int_mm, quantize_act, to_device)
from .quantize import quantize_folded


@dataclass(frozen=True)
class _LayerSpec:
    """Static streaming geometry of one conv layer (or the STFT framing)."""
    kernel: int
    stride: int
    dilation: int
    left: int               # offline left SAME-pad (even-total convention)
    pad_mode: str = 'reflect'   # 'reflect' (w2l) | 'zeros' (jasper)

    @property
    def ctx(self) -> int:
        return (self.kernel - 1) * self.dilation


def _plan(specs, prime_in: int, chunk_in: int):
    """Solve static carry lengths and per-phase output counts.

    Returns (carries, prime_outs, chunk_outs) -- all python ints -- or None
    if ``prime_in`` is too small (some layer cannot form its left reflect
    pad or emits nothing at prime). Zero-padded layers prime their left pad
    from a zeros carry, so only the emit-at-least-one constraint applies.
    """
    carries, prime_outs, chunk_outs = [], [], []
    p, f = prime_in, chunk_in
    for sp in specs:
        if (sp.pad_mode == 'reflect' and p < sp.left + 1) or f % sp.stride:
            return None
        q0 = (sp.left + p - sp.ctx - 1) // sp.stride + 1
        if q0 < 1:
            return None
        carry = sp.left + p - q0 * sp.stride
        # Steady-state invariant: with carry in [ctx+1-stride, ctx] and a
        # stride-divisible chunk, every step emits exactly f/stride frames
        # and the carry length is constant.
        assert (carry + f - sp.ctx - 1) // sp.stride + 1 == f // sp.stride
        carries.append(carry)
        prime_outs.append(q0)
        p, f = q0, f // sp.stride
        chunk_outs.append(f)
    return carries, prime_outs, chunk_outs


class StreamState(NamedTuple):
    """Carries between chunks, on the streamer's device, batch leading."""
    preemph_last: torch.Tensor      # [B, 1] last raw sample
    fe_carry: torch.Tensor          # [B, fe_carry_len] preemphasized samples
    conv_carries: tuple             # per layer [B, C_i, carry_i] ([B, carry_i,
    #                                 C_i] under int8_full)
    norm_count: torch.Tensor        # [B] valid frames seen
    norm_sum: torch.Tensor          # [B, M]
    norm_sumsq: torch.Tensor        # [B, M]


class _FrontendStreaming:
    """Streaming frontend phases (pre-emphasis -> framing -> K1 ->
    normalisation) shared by the streamers. Subclasses call
    ``_init_frontend`` during construction and the ``_fe_*`` phases from
    their own."""

    def _init_frontend(self, frontend, norm, norm_stats, chunk_frames,
                       device):
        self.device = resolve_device(device)
        self.frontend = frontend.to(self.device)
        self.hop = frontend.hop
        self.n_fft = frontend.n_fft
        self.n_mels = frontend.n_mels
        # Under MFCC the frontend's DCT follows K1 in every phase, so a
        # stream sees the feature space its model was trained on.
        self.feat_dim = frontend.feat_dim
        self.sample_rate = frontend.conf.sample_rate
        self.norm = norm
        if norm == 'precomputed':
            if norm_stats is None:
                raise ValueError("norm='precomputed' requires norm_stats")
            self._norm_mean, self._norm_std = (
                torch.as_tensor(np.asarray(a, np.float32),
                                device=self.device) for a in norm_stats)
        elif norm != 'cumulative':
            raise ValueError(f'unknown norm mode: {norm!r}')
        self._k1_tables = frontend.k1_tables()
        self.chunk_frames = chunk_frames
        self.chunk_samples = chunk_frames * self.hop
        # The STFT framing as a stream layer: width-n_fft stride-hop conv
        # with reflect left pad n_fft//2.
        self._fe_spec = _LayerSpec(self.n_fft, self.hop, 1, self.n_fft // 2)
        # Frontend frames lag the audio end by ceil((n_fft/2)/hop) (the
        # reflect-right region still owed when the stream ends); a tail of
        # <= chunk_samples therefore yields at most chunk_frames + lag
        # more frames.
        self._fe_lag = -(-(self.n_fft // 2) // self.hop)
        self._fin_frames = chunk_frames + self._fe_lag

    def audio_tensor(self, audio) -> torch.Tensor:
        """numpy audio -> a float32 tensor on the streamer's device."""
        return torch.as_tensor(np.asarray(audio, np.float32),
                               device=self.device)

    def _set_fin_zeros(self, fe_carry_len: int):
        need = self.n_fft + self.hop * (self._fin_frames - 1)
        self._fin_zeros = max(self.n_fft // 2,
                              need - fe_carry_len - self.chunk_samples)

    def _preemph(self, x, prev):
        """x[t] - 0.97*x[t-1] with ``prev`` as x[-1] (prime passes zeros,
        so the first sample is unchanged, as the offline frontend's)."""
        return x - PREEMPH * torch.cat([prev, x[:, :-1]], dim=1)

    def _frames_to_mel(self, buf, n_frames: int):
        """K1 over ``n_frames`` frames of ``buf`` [B, P], then the DCT
        under MFCC: [B, n, feat_dim]."""
        fe = self.frontend
        return fe.cepstra(fe.mel(buf.contiguous(), n_frames,
                                 self._k1_tables))

    def _normalize(self, feats, mask, count, nsum, nsumsq):
        """Masked normalisation; cumulative mode updates running stats
        (unbiased variance, as the offline frontend)."""
        if self.norm == 'precomputed':
            out = (feats - self._norm_mean) / (self._norm_std + NORM_EPS)
            return out * mask, count, nsum, nsumsq
        count = count + torch.sum(mask[:, :, 0], dim=1)
        nsum = nsum + torch.sum(feats * mask, dim=1)
        nsumsq = nsumsq + torch.sum(torch.square(feats) * mask, dim=1)
        c = torch.clamp(count, min=1.0)[:, None]
        mean = nsum / c
        var = torch.clamp((nsumsq - c * torch.square(mean))
                          / torch.clamp(c - 1.0, min=1.0), min=0.0)
        out = (feats - mean[:, None, :]) / (torch.sqrt(var)[:, None, :]
                                            + NORM_EPS)
        return out * mask, count, nsum, nsumsq

    def _fe_prime(self, audio):
        """First window: reflect-left prime. Returns
        (preemph_last, fe_carry, norm_state, feats [B, n, M])."""
        x = self._preemph(audio, torch.zeros_like(audio[:, :1]))
        left = x[:, 1:self.n_fft // 2 + 1].flip(1)
        buf = torch.cat([left, x], dim=1)
        n = (buf.shape[1] - self.n_fft) // self.hop + 1
        fe_carry = buf[:, n * self.hop:]
        feats = self._frames_to_mel(buf, n)
        B = audio.shape[0]
        mask = feats.new_ones((B, n, 1))
        count = feats.new_zeros((B,))
        nsum = feats.new_zeros((B, self.feat_dim))
        nsumsq = feats.new_zeros((B, self.feat_dim))
        feats, count, nsum, nsumsq = self._normalize(feats, mask, count,
                                                     nsum, nsumsq)
        return audio[:, -1:], fe_carry, (count, nsum, nsumsq), feats

    def _fe_step(self, preemph_last, fe_carry, norm_state, audio):
        x = self._preemph(audio, preemph_last)
        buf = torch.cat([fe_carry, x], dim=1)
        n = self.chunk_frames
        fe_carry = buf[:, n * self.hop:]
        feats = self._frames_to_mel(buf, n)
        mask = feats.new_ones((audio.shape[0], n, 1))
        feats, count, nsum, nsumsq = self._normalize(feats, mask,
                                                     *norm_state)
        return audio[:, -1:], fe_carry, (count, nsum, nsumsq), feats

    def _fe_finish(self, preemph_last, fe_carry, norm_state, tail,
                   tail_lengths, extra_zero_frames: int = 0):
        """Final window: per-row reflect-right at the true boundary, frames
        beyond flen zeroed. ``tail_lengths`` [B] is an int64 tensor on the
        device. Returns (feats [B, fin_frames + extra_zero_frames, M],
        valid_frames [B])."""
        B = tail.shape[0]
        x = self._preemph(tail, preemph_last)
        zeros = x.new_zeros((B, self._fin_zeros))
        buf = torch.cat([fe_carry, x, zeros], dim=1)
        fe_off = fe_carry.shape[1]
        pad = self.n_fft // 2
        P = buf.shape[1]
        # Offline puts audio[L-2-i] at padded position L+i (the long-row
        # case of the frontend's reflection); here audio[L-2-i] lives at
        # buf[fe_off + tail_len - 2 - i]. Gather indices clamp into the
        # row and the write starts clamp so it fits, as in JAX.
        pos = fe_off + tail_lengths[:, None]                   # [B, 1]
        ar = torch.arange(pad, device=buf.device)[None, :]
        idx = torch.clamp(pos - 2 - ar, 0, P - 1)
        right = torch.gather(buf, 1, idx)
        start = torch.clamp(pos, max=P - pad)
        padded = buf.scatter(1, start + ar, right)
        n = self._fin_frames
        feats = self._frames_to_mel(padded, n)
        valid = tail_lengths // self.hop + self._fe_lag        # [B] frames
        mask = (torch.arange(n, device=buf.device)[None, :]
                < valid[:, None])[:, :, None].to(feats.dtype)
        feats, _, _, _ = self._normalize(feats, mask, *norm_state)
        if extra_zero_frames:
            flush = feats.new_zeros((B, extra_zero_frames, feats.shape[2]))
            feats = torch.cat([feats, flush], dim=1)
        return feats, valid


class StreamingWav2Letter(_FrontendStreaming):
    """Chunked stateful inference over a trained Wav2Letter.

    Parameters
    ----------
    layers : the model's layer spec list, already truncated to mid_layers.
    num_labels : output labels (blank at 0).
    model : the port's ``Wav2Letter`` or its state dict (folded with
        ``fold_batchnorm``); may be None when ``folded`` is given.
    frontend : the offline ``SpectrogramFrontend`` (its geometry, DFT/mel
        constants and K1 tables are used, so streaming numerics match);
        moved to ``device``.
    chunk_frames : steady-state chunk size in STFT frames (divisible by the
        model's total stride). 64 frames = 640 ms at a 10 ms hop.
    norm : 'precomputed' (fixed stats; exact offline equivalence) or
        'cumulative' (running stats over frames seen so far).
    norm_stats : (mean [M], std [M]) -- required for 'precomputed'.
    weights : 'f32', 'int8' (weights quantized, float32 math) or
        'int8_full' (int8 weights and activations).
    folded : pre-folded weights (``fold_batchnorm``, ``quantize_folded``,
        or an artifact's from ``export.load_serving``); ``model`` and
        ``weights`` are then ignored, but for 'int8_full', which needs
        quantized ``folded``.
    padding_mode : the trained model's ('reflect', or 'zeros').
    act_scales : static int8 activation scales (one a conv, the head
        last) for 'int8_full'; without them each buffer's scale is
        dynamic (``max|x| / 127`` a row).
    device : where the phases run (default the card).
    """

    def __init__(self, layers, num_labels: int, model, frontend,
                 chunk_frames: int = 64, norm: str = 'cumulative',
                 norm_stats=None, weights: str = 'f32', folded=None,
                 padding_mode: str = 'reflect', act_scales=None,
                 device='cuda'):
        self.num_labels = num_labels
        self._act_scales = act_scales
        self._init_frontend(frontend, norm, norm_stats, chunk_frames, device)
        if padding_mode not in ('reflect', 'zeros'):
            raise ValueError(f'unknown padding_mode: {padding_mode!r}')

        # Layer geometry. The frontend's framing is spec[0]; conv left pads
        # use the even-total-frames convention (bucketed offline shapes are
        # even at the stride-2 layer).
        self._layer_cfg = [dict(l) for l in layers]
        specs = [self._fe_spec]
        for l in self._layer_cfg:
            k, s, d = (int(l['kernel_size']), int(l.get('stride', 1)),
                       int(l.get('dilation', 1)))
            # SAME pad for a stride-divisible input length at this layer:
            # out = t/s, so pad = (k-1)d + 1 - s, length-free.
            pad = max(0, (k - 1) * d + 1 - s)
            specs.append(_LayerSpec(k, s, d, pad // 2, padding_mode))
        specs.append(_LayerSpec(1, 1, 1, 0, padding_mode))  # 1x1 head
        self._specs = specs
        self.scale = int(np.prod([sp.stride for sp in specs[1:]]))
        if chunk_frames % self.scale:
            raise ValueError(f'chunk_frames must be divisible by the total '
                             f'stride {self.scale}')

        # Smallest prime window all layers can reflect-prime from.
        plan = None
        fp = chunk_frames
        while plan is None:
            fp += 1
            if fp > 1 << 16:
                raise ValueError('no feasible prime window; model lookahead '
                                 'too large for streaming')
            plan = _plan(specs, fp * self.hop, self.chunk_samples)
        self.prime_frames = fp
        self.prime_samples = fp * self.hop
        self._carries, self._prime_outs, self._chunk_outs = plan
        self.prime_out = self._prime_outs[-1]       # head frames at prime
        self.chunk_out = self._chunk_outs[-1]       # head frames per step
        # Algorithmic lookahead: input frames that must arrive beyond an
        # output's position before it can be emitted.
        la = 0
        for sp in reversed(specs[1:]):
            la = la * sp.stride + (sp.ctx - sp.left)
        self.lookahead_frames = la

        # ---- finish-phase static geometry ----
        self._set_fin_zeros(self._carries[0])
        # Max head frames still owed after the last steady chunk.
        rem_max = (fp + chunk_frames + 1) // self.scale - self.prime_out
        z = 0
        while True:
            # Simulate the conv stack over (finish frames + z zero frames).
            q, ok = self._fin_frames + z, True
            for sp, carry in zip(specs[1:], self._carries[1:]):
                q = (carry + q - sp.ctx - 1) // sp.stride + 1
                if q < 1:
                    ok = False
                    break
            if ok and q >= rem_max:
                self._fin_flush = z
                self._fin_out = q
                break
            z += self.scale

        self._act_int8 = weights == 'int8_full'
        if folded is not None:
            self._folded = list(folded)
        else:
            self._folded = fold_batchnorm(model, len(self._layer_cfg))
            if weights in ('int8', 'int8_full'):
                self._folded = quantize_folded(self._folded)
            elif weights != 'f32':
                raise ValueError(f'unknown weights mode: {weights!r}')
        if self._act_int8 and len(self._folded[0]) != 3:
            raise ValueError("weights='int8_full' needs quantized weights")
        # On the device once; every phase takes them as an argument.
        self._weights_dev = to_device(self._folded, self.device)
        if act_scales is not None:
            self._act_scale_dev = [
                torch.tensor(float(a), dtype=torch.float32,
                             device=self.device).reshape(1, 1, 1)
                for a in act_scales]
        self._prime_fn = self._prime
        self._step_fn = self._step
        self._finish_fn = self._finish

    # ------------------------------------------------------------------
    # phase programs (tensors on self.device in, tensors out)
    # ------------------------------------------------------------------

    def _a_scale(self, i, buf):
        if self._act_scales is not None:
            return self._act_scale_dev[i]
        return dynamic_act_scale(buf)

    def _conv_layers(self, folded, feats, carries, primed: bool):
        """Run the folded conv stack over new frames ``feats [B, n, M]``.
        When priming, ``carries`` is None and each layer pads its left edge
        from its first frames (reflect) or with zeros. Returns
        (log_probs [B, n_out, L], new_carries)."""
        q8 = self._act_int8
        t_dim = 1 if q8 else 2                     # time axis of a carry
        x = feats if q8 else feats.transpose(1, 2)
        new_carries = []
        for i, (sp, wb) in enumerate(zip(self._specs[1:-1], folded[:-1])):
            if primed:
                if sp.pad_mode == 'reflect':
                    left = x.narrow(t_dim, 1, sp.left).flip(t_dim)
                else:
                    shape = list(x.shape)
                    shape[t_dim] = sp.left
                    left = x.new_zeros(shape)
                buf = torch.cat([left, x], dim=t_dim)
            else:
                buf = torch.cat([carries[i], x], dim=t_dim)
            T = buf.shape[t_dim]
            q = (T - sp.ctx - 1) // sp.stride + 1
            new_carries.append(buf.narrow(t_dim, q * sp.stride,
                                          T - q * sp.stride))
            if q8:
                wq, w_scale, b = wb
                a_scale = self._a_scale(i, buf)
                out = conv_q8_valid(quantize_act(buf, a_scale), wq,
                                    sp.stride, sp.dilation)
                out = out.to(torch.float32) * (a_scale * w_scale[None, None])
                x = torch.clamp(out + b, *ACT_CLAMP)
            else:
                w, b = _materialize(wb, self.device)
                x = torch.clamp(F.conv1d(buf, w.permute(2, 1, 0), b,
                                         stride=sp.stride,
                                         dilation=sp.dilation), *ACT_CLAMP)
        if q8:
            wq, w_scale, bh = folded[-1]
            a_scale = self._a_scale(len(folded) - 1, x)
            B, T, C = x.shape
            acc = int_mm(quantize_act(x, a_scale).reshape(B * T, C), wq[0])
            logits = acc.view(B, T, -1).to(torch.float32) \
                * (a_scale * w_scale[None, None]) + bh
        else:
            wh, bh = _materialize(folded[-1], self.device)
            logits = torch.matmul(x.transpose(1, 2), wh[0]) + bh
        return F.log_softmax(logits, dim=-1), tuple(new_carries)

    @torch.no_grad()
    def _prime(self, folded, audio):
        last, fe_carry, norm_state, feats = self._fe_prime(audio)
        logp, conv_carries = self._conv_layers(folded, feats, None,
                                               primed=True)
        return StreamState(last, fe_carry, conv_carries, *norm_state), logp

    @torch.no_grad()
    def _step(self, folded, state, audio):
        last, fe_carry, norm_state, feats = self._fe_step(
            state.preemph_last, state.fe_carry,
            (state.norm_count, state.norm_sum, state.norm_sumsq), audio)
        logp, conv_carries = self._conv_layers(folded, feats,
                                               state.conv_carries,
                                               primed=False)
        return StreamState(last, fe_carry, conv_carries, *norm_state), logp

    @torch.no_grad()
    def _finish(self, folded, state, tail, tail_lengths):
        """tail: [B, chunk_samples] zero-padded; tail_lengths: [B] int64
        valid samples within it. Replicates the offline right boundary:
        reflect pad at each row's true end, zero features beyond flen,
        flush the conv lookahead over those zeros."""
        feats, _ = self._fe_finish(
            state.preemph_last, state.fe_carry,
            (state.norm_count, state.norm_sum, state.norm_sumsq),
            tail, tail_lengths, extra_zero_frames=self._fin_flush)
        logp, _ = self._conv_layers(folded, feats, state.conv_carries,
                                    primed=False)
        # Head frames still valid in this finish emission.
        fin_valid = (self.prime_frames + tail_lengths // self.hop + 1) \
            // self.scale - self.prime_out
        return logp, fin_valid

    # ------------------------------------------------------------------
    # session API
    # ------------------------------------------------------------------

    def start(self, batch_size: int = 1) -> 'StreamingSession':
        return StreamingSession(self, batch_size)


class StreamingSession:
    """Accumulates audio on the host, runs the phases on the device and
    keeps the emitted/valid frame bookkeeping on the host."""

    def __init__(self, model, batch_size: int):
        self.m = model
        self.B = batch_size
        self._buf = np.zeros((batch_size, 0), np.float32)
        self._state = None
        self._consumed = 0          # samples dispatched through prime/step
        self._head_emitted = 0
        self._finished = False

    def feed(self, audio) -> np.ndarray:
        """Append raw audio [B, n]; returns newly emitted log-probs
        [B, m, L] (m may be 0 while the prime window fills)."""
        if self._finished:
            raise RuntimeError('session already finished')
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        if audio.shape[0] != self.B:
            raise ValueError(f'expected batch {self.B}, got {audio.shape[0]}')
        self._buf = np.concatenate([self._buf, audio], axis=1)
        m = self.m
        outs = []
        while True:
            if self._state is None:
                if self._buf.shape[1] < m.prime_samples:
                    break
                chunk = self._buf[:, :m.prime_samples]
                self._buf = self._buf[:, m.prime_samples:]
                self._state, logp = m._prime_fn(m._weights_dev,
                                                m.audio_tensor(chunk))
                self._consumed += m.prime_samples
                self._head_emitted += m.prime_out
            elif self._buf.shape[1] >= m.chunk_samples:
                chunk = self._buf[:, :m.chunk_samples]
                self._buf = self._buf[:, m.chunk_samples:]
                self._state, logp = m._step_fn(m._weights_dev, self._state,
                                               m.audio_tensor(chunk))
                self._consumed += m.chunk_samples
                self._head_emitted += m.chunk_out
            else:
                break
            outs.append(logp.cpu().numpy())
        if not outs:
            return np.zeros((self.B, 0, m.num_labels), np.float32)
        return np.concatenate(outs, axis=1)

    def finish(self, lengths=None):
        """Flush the stream. ``lengths``: per-row TOTAL sample counts
        (default: everything fed). Each row's end must fall after the last
        dispatched chunk (within the final partial window). Returns
        (log_probs [B, m, L], valid [B]) -- ``valid`` counts frames of this
        finish emission; earlier feed() emissions are all valid."""
        if self._finished:
            raise RuntimeError('session already finished')
        if self._state is None:
            raise ValueError(
                f'stream shorter than the prime window '
                f'({self.m.prime_samples} samples); use the offline path')
        total_fed = self._consumed + self._buf.shape[1]
        if lengths is None:
            lengths = np.full((self.B,), total_fed, np.int64)
        lengths = np.asarray(lengths, np.int64)
        tail_len = lengths - self._consumed
        if np.any(tail_len < 0) or np.any(tail_len > self.m.chunk_samples):
            raise ValueError('every sample must end within the final '
                             'partial chunk; pad shorter streams offline '
                             'or run them in their own session')
        tail = np.zeros((self.B, self.m.chunk_samples), np.float32)
        avail = self._buf.shape[1]
        if avail:
            tail[:, :avail] = self._buf
        self._finished = True
        logp, valid = self.m._finish_fn(
            self.m._weights_dev, self._state, self.m.audio_tensor(tail),
            torch.as_tensor(tail_len, device=self.m.device))
        return logp.cpu().numpy(), valid.cpu().numpy()

    @property
    def head_frames_emitted(self) -> int:
        return self._head_emitted

    @property
    def consumed_samples(self) -> int:
        """Samples already dispatched; every stream's true end must lie in
        [consumed_samples, consumed_samples + chunk_samples] at finish()."""
        return self._consumed


def greedy_collapse(ids, last: int):
    """One incremental greedy-CTC collapse step: collapse repeats, drop
    blanks (id 0), carrying the previous frame's id across chunk
    boundaries. Returns (emitted label ids, their frame positions, new
    carry)."""
    out, pos = [], []
    for t, i in enumerate(ids):
        i = int(i)
        if i != 0 and i != last:
            out.append(i)
            pos.append(t)
        last = i
    return out, pos, last


class StreamingBeamTranscriber:
    """Incremental beam-search transcription over a streaming session.

    The CTC prefix-beam DP reads only the previous time step, so it
    advances chunk by chunk (``decoding.decoder.IncrementalPrefixBeam``)
    with optional LM fusion at word boundaries; the live best hypothesis
    is available after every feed, and the final result equals offline
    ``prefix_beam_search`` on the whole utterance."""

    def __init__(self, session: StreamingSession, labels, lm_path: str = '',
                 k: int = None, alpha: float = None, beta: float = None,
                 prune: float = None, hotwords=None,
                 hotword_weight: float = 2.0):
        """``hotwords``: contextual-biasing words/phrases applied inside
        the incremental DP. k/alpha/beta/prune default (None) to the
        corpus-sweep winners (``decoding.decoder.DEFAULT_BEAM_*``)."""
        from ..decoding.decoder import (DEFAULT_BEAM_ALPHA, DEFAULT_BEAM_BETA,
                                        DEFAULT_BEAM_K, DEFAULT_BEAM_PRUNE,
                                        IncrementalPrefixBeam)
        k = DEFAULT_BEAM_K if k is None else k
        alpha = DEFAULT_BEAM_ALPHA if alpha is None else alpha
        beta = DEFAULT_BEAM_BETA if beta is None else beta
        prune = DEFAULT_BEAM_PRUNE if prune is None else prune
        lm = None
        if lm_path:
            from ..decoding.arpa_lm import load_lm
            model = load_lm(lm_path)
            lm = lambda s: 10 ** model.score(s)  # noqa: E731
        self.session = session
        # Jasper sessions emit probabilities; Wav2Letter log-probs.
        self._emits_probs = getattr(session.m, 'emits_probs', False)
        self._beams = [IncrementalPrefixBeam(list(labels), lm=lm, k=k,
                                             alpha=alpha, beta=beta,
                                             prune=prune, hotwords=hotwords,
                                             hotword_weight=hotword_weight)
                       for _ in range(session.B)]

    def _advance(self, out, valid=None):
        probs = out if self._emits_probs else np.exp(out)
        bests = []
        for b, beam in enumerate(self._beams):
            n = probs.shape[1] if valid is None else int(valid[b])
            bests.append(beam.step(probs[b, :n]) if n else beam.result())
        return bests

    def feed(self, audio):
        """Returns the current-best hypothesis per stream."""
        return self._advance(self.session.feed(audio))

    def finish(self, lengths=None):
        out, valid = self.session.finish(lengths)
        return self._advance(out, valid)

    @property
    def text(self):
        return [beam.result() for beam in self._beams]


def stream_logprobs(model, audio, length: int | None = None) -> np.ndarray:
    """Run ONE utterance through a fresh streaming session; returns the
    concatenated valid outputs ``[1, T', L]``. Shared by the eval CLIs."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    sess = model.start(1)
    outs = []
    for s in range(0, audio.shape[1], model.chunk_samples):
        outs.append(sess.feed(audio[:, s:s + model.chunk_samples]))
    fin, valid = sess.finish(
        None if length is None else np.array([length]))
    return np.concatenate(
        [o for o in outs if o.shape[1]] + [fin[:, :int(valid[0])]], axis=1)


class StreamingTranscriber:
    """Incremental greedy CTC transcription over a streaming session:
    collapse repeats then drop blanks, with the repeat state carried across
    chunk boundaries. Per-character frame offsets are tracked globally, so
    ``word_timings`` matches the offline ``get_time_per_word``."""

    def __init__(self, session: StreamingSession, labels):
        self.session = session
        self.labels = list(labels)
        self._last = [0] * session.B   # previous frame's argmax id
        self._text = [''] * session.B
        self._offsets = [[] for _ in range(session.B)]
        self._frame = [0] * session.B  # global output frames consumed

    def _consume(self, logp, valid=None):
        if logp.shape[1] == 0:
            return ['' for _ in range(self.session.B)]
        ids = np.argmax(logp, axis=-1)      # [B, T]
        fresh = []
        for b in range(self.session.B):
            n = logp.shape[1] if valid is None else int(valid[b])
            out, pos, self._last[b] = greedy_collapse(ids[b, :n],
                                                      self._last[b])
            self._offsets[b].extend(self._frame[b] + t for t in pos)
            self._frame[b] += n
            fresh.append(''.join(self.labels[i] for i in out))
            self._text[b] += fresh[-1]
        return fresh

    def feed(self, audio):
        """Returns the newly decoded text per stream."""
        return self._consume(self.session.feed(audio))

    def finish(self, lengths=None):
        """Flush; returns the final complete transcripts."""
        logp, valid = self.session.finish(lengths)
        self._consume(logp, valid)
        return list(self._text)

    @property
    def text(self):
        return list(self._text)

    def word_timings(self, frame_seconds: float):
        """[(word, start_s, end_s)] per stream, the streaming counterpart
        of the offline ``get_time_per_word`` path. ``frame_seconds`` =
        window_stride x the model's scaling factor."""
        from ..decoding.decoder import get_time_per_word
        return [get_time_per_word(list(self._text[b]), self._offsets[b],
                                  ratio=frame_seconds)
                for b in range(self.session.B)]
