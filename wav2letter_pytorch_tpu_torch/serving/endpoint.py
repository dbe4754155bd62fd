"""CTC endpointing: live end-of-utterance detection and segmented
streaming transcription for continuous streams.

The counterpart of the JAX package's ``serving/endpoint.py``, over the
port's streaming sessions and decoders. An output frame is *silence* when
p(blank) >= ``blank_threshold``; an endpoint fires once
``trailing_blank_frames`` consecutive silence frames follow a segment that
has emitted at least one character. On endpoint the segment is finalized
(its text, start/end output frames) and the per-stream decoder state
resets, so a session can run for hours with bounded state: partial results
while speaking, a FINAL per utterance at each detected pause.

Exactness: ``blank_threshold >= 0.5`` makes the argmax at every silence
frame the blank, where greedy CTC collapse emits nothing and parks its
repeat carry on blank, so the concatenation of finalized greedy segments
plus the live partial equals un-segmented streaming greedy decoding
character for character. Beam mode decodes each segment with an
independent prefix-beam DP over that segment's frames, trading the
global DP's exactness for bounded state, as offline segmented decoding
does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Segment:
    """One finalized utterance segment.

    ``start_frame``/``end_frame`` index the model's OUTPUT frames globally
    (end exclusive, i.e. one past the last emitted character's frame);
    multiply by window_stride x the model's scaling factor for seconds.
    """
    text: str
    start_frame: int
    end_frame: int

    def timing(self, frame_seconds: float):
        return (self.text, self.start_frame * frame_seconds,
                self.end_frame * frame_seconds)


class SegmentingTranscriber:
    """Endpointing transcription over a ``StreamingSession``.

    ``decoder='greedy'`` finalizes each segment's incrementally collapsed
    characters; ``decoder='beam'`` buffers the segment's probability frames
    and runs an independent prefix beam search (with optional ARPA LM
    fusion and hotword biasing — same knobs as StreamingBeamTranscriber)
    when the endpoint fires. In both modes the *endpoint detector* is the
    greedy emission stream: a segment exists once any non-blank argmax
    character appears, and closes after ``trailing_blank_frames``
    consecutive frames with p(blank) >= ``blank_threshold``. Pure silence
    between utterances never produces empty segments, and beam segments
    whose decode strips to the empty string are dropped (matching offline
    ``decode_segmented``). Pause-free audio cannot grow state unboundedly:
    a segment is force-finalized once it spans ``max_segment_frames``
    output frames (the online analogue of ``blank_segments(max_frames=...)``
    in longform.py) — greedy concatenation stays exact across such splits
    because the repeat-collapse carry survives them.
    """

    def __init__(self, session, labels, blank_threshold: float = 0.98,
                 trailing_blank_frames: int = 30, decoder: str = 'greedy',
                 lm_path: str = '', k: int = None, alpha: float = None,
                 beta: float = None, prune: float = None, hotwords=None,
                 hotword_weight: float = 2.0,
                 max_segment_frames: int = 1200):
        # Beam hyperparameters default to the corpus-sweep winners
        # (decoding.decoder.DEFAULT_BEAM_*).
        from ..decoding.decoder import (DEFAULT_BEAM_ALPHA, DEFAULT_BEAM_BETA,
                                        DEFAULT_BEAM_K, DEFAULT_BEAM_PRUNE)
        k = DEFAULT_BEAM_K if k is None else k
        alpha = DEFAULT_BEAM_ALPHA if alpha is None else alpha
        beta = DEFAULT_BEAM_BETA if beta is None else beta
        prune = DEFAULT_BEAM_PRUNE if prune is None else prune
        if not 0.5 <= blank_threshold <= 1.0:
            raise ValueError('blank_threshold must lie in [0.5, 1] so that '
                             'silence frames are argmax-blank (greedy '
                             'concatenation parity depends on it)')
        if trailing_blank_frames < 1:
            raise ValueError('trailing_blank_frames must be >= 1')
        if max_segment_frames < 1:
            raise ValueError('max_segment_frames must be >= 1')
        if decoder not in ('greedy', 'beam'):
            raise ValueError(f'unknown decoder mode: {decoder!r}')
        self.session = session
        self.labels = list(labels)
        self.blank_threshold = float(blank_threshold)
        self.trailing = int(trailing_blank_frames)
        self.max_segment_frames = int(max_segment_frames)
        self.mode = decoder
        # Jasper sessions emit probabilities; Wav2Letter log-probs.
        self._emits_probs = getattr(session.m, 'emits_probs', False)
        self._beam_opts = dict(lm_path=lm_path, k=k, alpha=alpha, beta=beta,
                               prune=prune, hotwords=hotwords,
                               hotword_weight=hotword_weight)
        self._lm = None
        if decoder == 'beam' and lm_path:
            from ..decoding.arpa_lm import load_lm
            model = load_lm(lm_path)
            self._lm = lambda s: 10 ** model.score(s)
        B = session.B
        self._last = [0] * B           # previous frame's argmax id
        self._run = [0] * B            # current trailing-silence run length
        self._chars: List[List[str]] = [[] for _ in range(B)]
        self._start: List[Optional[int]] = [None] * B
        self._end = [0] * B
        self._frame = [0] * B          # global output frames consumed
        self._buf: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._segments: List[List[Segment]] = [[] for _ in range(B)]
        self._finished = False

    # -- decoding ---------------------------------------------------------

    def _beam_decode(self, frames: List[np.ndarray]) -> str:
        from ..decoding.decoder import IncrementalPrefixBeam
        o = self._beam_opts
        beam = IncrementalPrefixBeam(self.labels, lm=self._lm, k=o['k'],
                                     alpha=o['alpha'], beta=o['beta'],
                                     prune=o['prune'],
                                     hotwords=o['hotwords'],
                                     hotword_weight=o['hotword_weight'])
        beam.step(np.stack(frames))
        return beam.result().strip()

    def _finalize(self, b: int) -> Optional[Segment]:
        if self.mode == 'beam':
            text = self._beam_decode(self._buf[b])
        else:
            text = ''.join(self._chars[b])
        start, end = self._start[b], self._end[b]
        self._chars[b] = []
        self._buf[b] = []
        self._start[b] = None
        self._run[b] = 0
        if not text:
            # Beam on a space-only/empty segment can strip to nothing —
            # match offline decode_segmented, which drops empty texts.
            return None
        seg = Segment(text, int(start), int(end))
        self._segments[b].append(seg)
        return seg

    def _consume(self, out, valid=None):
        B = self.session.B
        new: List[List[Segment]] = [[] for _ in range(B)]
        if out.shape[1] == 0:
            return new
        probs = out if self._emits_probs else np.exp(out)
        ids = np.argmax(probs, axis=-1)                    # [B, T]
        silence = probs[..., 0] >= self.blank_threshold    # [B, T]
        for b in range(B):
            n = probs.shape[1] if valid is None else int(valid[b])
            for t in range(n):
                i = int(ids[b, t])
                g = self._frame[b] + t
                if i != 0 and i != self._last[b]:
                    self._chars[b].append(self.labels[i])
                    if self._start[b] is None:
                        self._start[b] = g
                    self._end[b] = g + 1
                self._last[b] = i
                if self.mode == 'beam' and self._start[b] is not None:
                    self._buf[b].append(probs[b, t])
                if silence[b, t]:
                    self._run[b] += 1
                    if self._run[b] >= self.trailing and self._chars[b]:
                        seg = self._finalize(b)
                        if seg is not None:
                            new[b].append(seg)
                elif (self._start[b] is not None
                      and g + 1 - self._start[b] >= self.max_segment_frames):
                    # Pause-free audio: force-finalize so per-stream state
                    # (beam buffer, DP precision) stays bounded — the online
                    # analogue of longform.blank_segments' max_frames split.
                    # Greedy concatenation stays exact: the repeat-collapse
                    # carry (_last) survives the split.
                    seg = self._finalize(b)
                    if seg is not None:
                        new[b].append(seg)
                else:
                    self._run[b] = 0
            self._frame[b] += n
        return new

    # -- public surface ---------------------------------------------------

    def feed(self, audio):
        """Feed an audio chunk; returns the NEWLY finalized segments per
        stream (usually empty lists — finals appear at detected pauses)."""
        if self._finished:
            raise RuntimeError('SegmentingTranscriber already finished')
        return self._consume(self.session.feed(audio))

    def finish(self, lengths=None):
        """Flush the session; any in-progress segment is finalized. Returns
        the newly finalized segments per stream."""
        if self._finished:
            raise RuntimeError('SegmentingTranscriber already finished')
        out, valid = self.session.finish(lengths)
        new = self._consume(out, valid)
        self._finished = True
        for b in range(self.session.B):
            if self._chars[b]:
                seg = self._finalize(b)
                if seg is not None:
                    new[b].append(seg)
        return new

    @property
    def segments(self) -> List[List[Segment]]:
        """All segments finalized so far, per stream."""
        return [list(s) for s in self._segments]

    @property
    def partial(self) -> List[str]:
        """Current in-progress (not yet finalized) text per stream. Greedy
        mode reads the incremental collapse; beam mode decodes the
        buffered segment frames on demand."""
        if self.mode == 'beam':
            return [self._beam_decode(buf) if buf else ''
                    for buf in self._buf]
        return [''.join(c) for c in self._chars]

    def timings(self, frame_seconds: float):
        """[(text, start_s, end_s)] per stream for all finalized segments;
        ``frame_seconds`` = window_stride x the model's scaling factor."""
        return [[seg.timing(frame_seconds) for seg in segs]
                for segs in self._segments]
