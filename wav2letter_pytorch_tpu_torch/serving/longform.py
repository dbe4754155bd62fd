"""Exact long-form inference: overlap-chunked windows over one long
utterance.

The counterpart of the JAX package's ``serving/longform.py``. The frontend
runs once over the whole utterance (per-utterance normalisation is global,
and features are small next to activations); the features are cut into
overlapping windows whose overlap covers the conv stack's receptive field;
the windows run as batches through the offline stack, and each window is
cropped to its core frames. The result is the one-shot computation, with
memory bounded by the window batch.

Exactness rests on two alignments, both from ``models/base.py::
same_pad_amount``, whose left/right pad split depends on ``t_in mod
stride``:

* every window starts on the cumulative-stride grid (``a = 0 mod S``), so
  local output ``j`` is global output ``j + a / S`` at every layer;
* every window has length ``W = T0 (mod S)``, so each layer's local SAME
  split equals the global one.

Windows are all of one length (starts clamp to ``[0, T0 - W]``, on the grid
since ``T0 - W = 0 mod S``); interior windows' kept outputs depend only on
real frames, and the boundary windows start or end at the utterance's
edge, where the local SAME padding is the global one.

BN-folded Wav2Letter stacks only. int8_full is exact with static
``act_scales``; dynamic scales reduce per window, not per utterance.
With a ``mesh`` each group of windows is split over its devices (the
group rounded to a multiple of the mesh size), every group is launched
before any result is fetched, and the results come back to the
frontend's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Mesh, shard_rows
from ..runtime import resolve_device
from .infer import (_layer_geometry, offline_forward, offline_forward_q8,
                    to_device)


def stack_geometry(layers):
    """(S, P, Q): cumulative stride and conservative left/right receptive
    field of the conv stack, in input-frame units (the whole ``(k-1)*d`` on
    either side, valid for every length parity)."""
    S, P, Q = 1, 0, 0
    for k, s, d in _layer_geometry(layers):
        reach = (k - 1) * d
        P += S * reach
        Q += S * reach
        S *= s
    return S, P, Q


def plan_windows(t_frames: int, layers, chunk_frames: int):
    """Chunking plan over a ``t_frames``-long feature sequence.

    Returns ``(W, out_w, starts, keeps)``: windows are ``feats[a : a+W]``
    for ``a`` in ``starts`` (all of length ``W``), ``out_w`` is a window's
    output frame count, and ``keeps[i] = (j0_local, j1_local, j0_global)``
    crops window ``i``'s core. ``W`` is None when one shot covers all.
    """
    S, P, Q = stack_geometry(layers)
    h_l = -(-P // S) + 1          # halo in output frames, +1 slack
    h_r = -(-Q // S) + 1
    core = int(chunk_frames)
    if core < 1:
        raise ValueError('chunk_frames must be >= 1')
    w_base = S * (core + h_l + h_r)
    # W = t_frames (mod S): equal per-layer pad splits, local and global.
    w = w_base + (t_frames - w_base) % S
    t_out = _out_frames(t_frames, layers)
    if w >= t_frames:
        return None, t_out, [0], [(0, t_out, 0)]
    out_w = _out_frames(w, layers)
    starts, keeps = [], []
    n_chunks = -(-t_out // core)
    for i in range(n_chunks):
        a = min(max(0, S * (i * core - h_l)), t_frames - w)
        j0, j1 = i * core, min((i + 1) * core, t_out)
        starts.append(a)
        keeps.append((j0 - a // S, j1 - a // S, j0))
    return w, out_w, starts, keeps


def _out_frames(t: int, layers) -> int:
    for _, s, _ in _layer_geometry(layers):
        t = -(-t // s)
    return t


def make_window_forward(layers, folded, mode: str = 'f32',
                        padding_mode: str = 'reflect', act_scales=None,
                        f32_layers=()):
    """``(weights, feats [B, T, F], lengths [B] | None) -> (log_probs
    [B, T', L], out_lengths)``: the folded stack in ``mode``, 'f32' /
    'int8' (float32 math, int8 weights dequantized) or 'int8_full' (int8
    activations too, which needs quantized weights). ``lengths`` None: every
    frame is real, as in a long-form window. Shared by ``MeshInference``,
    the long-form windows and ``transcribe_long``'s one-shot check."""
    if mode == 'int8_full':
        if len(folded[0]) != 3:
            raise ValueError("mode='int8_full' needs quantized weights")

        def fwd(w, f, lens=None):
            return offline_forward_q8(layers, w, f, lens,
                                      padding_mode=padding_mode,
                                      act_scales=act_scales,
                                      f32_layers=f32_layers)
    elif mode in ('f32', 'int8'):
        def fwd(w, f, lens=None):
            return offline_forward(layers, w, f, lens,
                                   padding_mode=padding_mode)
    else:
        raise ValueError(f'unknown mode: {mode!r}')
    return fwd


def longform_logprobs(layers, folded, frontend, audio, mode: str = 'f32',
                      padding_mode: str = 'reflect', act_scales=None,
                      f32_layers=(), chunk_frames: int = 2000,
                      max_batch: int = 8, mesh=None, fwd=None,
                      weights=None):
    """Log-probs of ONE long utterance, equal to the one-shot offline run.

    ``audio``: 1-D samples. ``frontend``: on the device to run on (the
    stack runs there too). ``chunk_frames``: core output frames a window
    (the memory knob; halos come from the receptive field). ``max_batch``:
    windows a call. ``mesh``: a ``parallel.Mesh`` to spread the windows
    over (None: the frontend's device alone). ``fwd``/``weights``: a
    prebuilt ``make_window_forward`` and the weights (a ``to_device``
    copy on each of the mesh's devices), for repeated calls. Returns
    ``(log_probs [T_out, L], valid_frames)`` as numpy, ``valid_frames =
    frames // S`` (``offline_forward``'s floor convention).
    """
    dev = frontend.fb_t.device
    audio = np.asarray(audio, np.float32).reshape(-1)
    with torch.no_grad():
        feats, flens = frontend(
            torch.from_numpy(audio[None, :]).to(dev),
            torch.tensor([audio.shape[0]], dtype=torch.int32, device=dev))
        t_frames = int(flens[0])
        feats = feats[0, :t_frames]

        S, _, _ = stack_geometry(layers)
        w_len, _, starts, keeps = plan_windows(t_frames, layers,
                                               chunk_frames)
        if fwd is None:
            fwd = make_window_forward(layers, folded, mode=mode,
                                      padding_mode=padding_mode,
                                      act_scales=act_scales,
                                      f32_layers=f32_layers)
        if mesh is None:
            mesh = Mesh([dev])
        max_batch = max(max_batch // mesh.size, 1) * mesh.size
        if weights is None:
            weights = [to_device(folded, d) for d in mesh.devices]
        if w_len is None:                      # short utterance: one shot
            return (fwd(weights[0], feats[None])[0][0].cpu().numpy(),
                    t_frames // S)

        launched = []
        for lo in range(0, len(starts), max_batch):
            group = [feats[a:a + w_len] for a in starts[lo:lo + max_batch]]
            # the last group repeats its last window to the full batch
            group += group[-1:] * (max_batch - len(group))
            launched.append([fwd(w, part)[0] for w, part in zip(
                weights, shard_rows(torch.stack(group), mesh))])
        out = None
        for lo, parts in zip(range(0, len(starts), max_batch), launched):
            logp = torch.cat([p.to(dev) for p in parts])
            if out is None:
                out = logp.new_empty((_out_frames(t_frames, layers),
                                      logp.shape[-1]))
            for gi, (j0, j1, g0) in enumerate(keeps[lo:lo + max_batch]):
                out[g0:g0 + (j1 - j0)] = logp[gi, j0:j1]
    return out.cpu().numpy(), t_frames // S


def blank_segments(log_probs, blank_index: int = 0,
                   min_blank_run: int = 20, max_frames: int = 1200):
    """Split a long utterance's output frames at confident silences.

    Probability-space beam DPs underflow float64 after a few thousand
    frames, so hour-scale outputs are decoded in utterance-scale pieces.
    Cuts go at the centres of argmax-blank runs of at least
    ``min_blank_run`` frames; a segment still longer than ``max_frames`` is
    split recursively at its longest interior blank run. Returns a list of
    (start, end) frame ranges covering [0, T).
    """
    am = np.asarray(log_probs).argmax(-1)
    T = len(am)
    runs = []                    # maximal blank runs as (start, length)
    run = 0
    for t in range(T + 1):
        if t < T and am[t] == blank_index:
            run += 1
        else:
            if run:
                runs.append((t - run, run))
            run = 0

    cuts = [s + ln // 2 for s, ln in runs if ln >= min_blank_run]
    segs = []
    prev = 0
    for c in cuts:
        if c > prev:
            segs.append((prev, c))
            prev = c
    if prev < T:
        segs.append((prev, T))

    def split(a, b):
        if b - a <= max_frames:
            return [(a, b)]
        best = None              # the longest blank run strictly inside
        for s, ln in runs:
            c = s + ln // 2
            if a < c < b and (best is None or ln > best[1]):
                best = (c, ln)
        c = best[0] if best is not None else (a + b) // 2
        if c <= a or c >= b:
            return [(a, b)]
        return split(a, c) + split(c, b)

    return [piece for a, b in (segs or [(0, T)]) for piece in split(a, b)]


def decode_segmented(log_probs, decoder, blank_index: int = 0,
                     min_blank_run: int = 20, is_log: bool = True):
    """Beam-decode a long output by independent silence-bounded segments
    and join them with spaces."""
    texts = []
    for a, b in blank_segments(log_probs, blank_index, min_blank_run):
        seg = log_probs[a:b]
        out = decoder.decode(np.exp(seg) if is_log else seg)
        out = out.strip()
        if out:
            texts.append(out)
    return ' '.join(texts)


class LongFormTranscriber:
    """Folded weights + frontend + decoder -> ``transcribe(audio) -> str``
    for recordings of any length, on ``device`` (with a ``mesh``, its
    first device, the windows spread over all of them). The weights are
    copied there once (``weights``); ``fwd`` is the stack's
    ``make_window_forward``."""

    def __init__(self, layers, folded, frontend, decoder, mode='f32',
                 padding_mode='reflect', act_scales=None, f32_layers=(),
                 chunk_frames: int = 2000, max_batch: int = 8, mesh=None,
                 device='cuda'):
        dev = resolve_device(device if mesh is None else mesh.devices[0])
        self._kw = dict(mode=mode, padding_mode=padding_mode,
                        act_scales=act_scales, f32_layers=f32_layers,
                        chunk_frames=chunk_frames, max_batch=max_batch,
                        mesh=mesh)
        self.layers, self.folded = layers, folded
        self.frontend = frontend.to(dev)
        self.decoder = decoder
        self.fwd = make_window_forward(layers, folded, mode=mode,
                                       padding_mode=padding_mode,
                                       act_scales=act_scales,
                                       f32_layers=f32_layers)
        self.weights = to_device(folded, dev)
        self._weights = [self.weights] + [
            to_device(folded, d) for d in (mesh.devices[1:] if mesh else [])]

    def logprobs(self, audio):
        return longform_logprobs(self.layers, self.folded, self.frontend,
                                 audio, fwd=self.fwd, weights=self._weights,
                                 **self._kw)

    def transcribe(self, audio) -> str:
        logp, valid = self.logprobs(audio)
        return self.decoder.decode(logp[None, :valid, :],
                                   sizes=np.array([valid]))[0]
