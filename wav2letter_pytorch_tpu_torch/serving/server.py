"""Stream multiplexer: batch many live audio streams into one session.

The counterpart of the JAX package's ``serving/server.py``.
``StreamMultiplexer`` owns one batched streaming state with a fixed number
of SLOTS; streams attach to a free slot, feed audio, and detach with a
final transcript, and every slot's row advances in one batched step a
tick (K1 once and the conv stack once for all slots).

Attach and detach stay cheap because every state tensor carries the batch
as its leading axis and rows never interact: a newly attached stream runs
the one-row prime and its state rows are copied into the batched state
(``index_copy_``); a detaching stream's rows are sliced out and flushed
through the one-row finish. Idle slots keep stepping over silence; their
output is discarded and the next attach overwrites their rows.

Contract: this is the transport layer for real-time streams -- by each
``tick()`` every attached and primed stream must have one chunk of audio
buffered. ``tick_ready()`` steps only the streams that do and keeps the
other rows as they were (``torch.where``). Greedy incremental
transcription is built in; for beam or custom decoding drive a dedicated
``StreamingSession`` instead.

Over a ``parallel.Mesh`` of n devices the slot axis is split: slots
``[i * slots / n, (i + 1) * slots / n)`` and their state rows live on
device ``i``, served by a streamer built on that device (the caller
builds one a device from its source: ``streaming_from_artifact(...,
device=d)``). A tick
launches every device's step on its rows of the chunk batch before it
fetches any result. Rows never interact, so the split needs no
collective.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import canonical
from .streaming import greedy_collapse


def _map_state(fn, *states):
    """``fn`` over the matching tensors of ``states``, a streamer's state
    (``StreamState``, ``JasperStreamState``): tuples, named or not, are
    rebuilt as their own type around their mapped items, at any depth
    (the Jasper state's norm statistics are a tuple of triples)."""
    first = states[0]
    if not isinstance(first, tuple):
        return fn(*states)
    out = [_map_state(fn, *parts) for parts in zip(*states)]
    return type(first)(*out) if hasattr(first, '_fields') else tuple(out)


class StreamMultiplexer:
    """Multiplex up to ``slots`` live streams through one batched session.

    ``model``: a ``StreamingWav2Letter`` or a ``StreamingJasper``; the
    batched state lives on its device. With ``mesh`` (a ``parallel.Mesh``
    whose size divides ``slots``) the state is split over the mesh's
    devices, and ``model`` is a list of one streamer a device, each on
    its device, or one streamer when every device of the mesh is its own.
    """

    def __init__(self, model, slots: int = 16, labels=None, mesh=None):
        if labels is None:
            raise ValueError('labels are required (greedy transcription is '
                             'the multiplexer output; for custom decoding '
                             'use StreamingSession directly)')
        models = list(model) if isinstance(model, (list, tuple)) else [model]
        if mesh is not None:
            if slots % mesh.size:
                raise ValueError(f'slots ({slots}) must be divisible by '
                                 f'the mesh size ({mesh.size})')
            if len(models) == 1:
                models = models * mesh.size
            want = [canonical(d) for d in mesh.devices]
            have = [canonical(m.device) for m in models]
            if have != want:
                raise ValueError(
                    f'streamers on {[str(d) for d in have]} for {mesh}: '
                    'build one streamer on each of its devices')
        elif len(models) > 1:
            raise ValueError('several streamers need a mesh')
        self.m = model = models[0]
        self.slots = slots
        self.labels = list(labels)
        self.mesh = mesh
        self._rows = slots // len(models)
        # Bootstrap a valid batched state on each device: tile a one-row
        # silence prime over its rows.
        silence = np.zeros((1, model.prime_samples))
        self._parts = []
        for m in models:
            row, _ = m._prime_fn(m._weights_dev, m.audio_tensor(silence))
            self._parts.append([m, _map_state(
                lambda s: s.repeat_interleave(self._rows, dim=0), row)])
        self._buf = [np.zeros(0, np.float32)] * slots
        self._active = [False] * slots
        self._primed = [False] * slots
        self._consumed = [0] * slots
        self._last = [0] * slots
        self._text = [''] * slots

    # ------------------------------------------------------------------

    def attach(self) -> int:
        """Claim a free slot for a new stream. Raises when full."""
        for s in range(self.slots):
            if not self._active[s]:
                self._active[s] = True
                self._primed[s] = False
                self._buf[s] = np.zeros(0, np.float32)
                self._consumed[s] = 0
                self._last[s] = 0
                self._text[s] = ''
                return s
        raise RuntimeError(f'all {self.slots} slots busy')

    def feed(self, slot: int, audio) -> None:
        """Buffer audio for ``slot``; primes the slot once enough has
        arrived (copying its fresh state rows into the batch)."""
        if not self._active[slot]:
            raise ValueError(f'slot {slot} is not attached')
        self._buf[slot] = np.concatenate(
            [self._buf[slot], np.asarray(audio, np.float32).ravel()])
        if (not self._primed[slot]
                and len(self._buf[slot]) >= self.m.prime_samples):
            chunk = self._buf[slot][:self.m.prime_samples][None]
            self._buf[slot] = self._buf[slot][self.m.prime_samples:]
            m, state = self._parts[slot // self._rows]
            row_state, logp = m._prime_fn(m._weights_dev,
                                          m.audio_tensor(chunk))
            index = torch.tensor([slot % self._rows], device=m.device)
            _map_state(lambda s, r: s.index_copy_(0, index, r.to(s.dtype)),
                       state, row_state)
            self._consumed[slot] = self.m.prime_samples
            self._primed[slot] = True
            self._decode(slot, logp[0].cpu().numpy())

    def tick(self):
        """Advance every primed stream by one chunk in a single batched
        step. Returns {slot: new_text} for primed streams."""
        cs = self.m.chunk_samples
        stepped = [s for s in range(self.slots)
                   if self._active[s] and self._primed[s]]
        if not stepped:
            return {}
        for s in stepped:
            if len(self._buf[s]) < cs:
                raise RuntimeError(
                    f'slot {s} starved: {len(self._buf[s])} < {cs} '
                    'samples buffered at tick (real-time contract)')
        return self._step(stepped)

    def tick_ready(self):
        """Advance only the primed streams holding a full buffered chunk.

        The jitter-tolerant variant of :meth:`tick` for network transports
        (``net.py``): a lagging client does not advance this round instead
        of poisoning the whole batch. Rows of skipped slots keep their old
        values (one ``torch.where`` a state tensor); rows never interact,
        so skipped slots are bit-identical to not having stepped at all.
        """
        cs = self.m.chunk_samples
        stepped = [s for s in range(self.slots)
                   if self._active[s] and self._primed[s]
                   and len(self._buf[s]) >= cs]
        if not stepped:
            return {}
        return self._step(stepped)

    def _step(self, stepped):
        cs = self.m.chunk_samples
        chunks = np.zeros((self.slots, cs), np.float32)
        for s in stepped:
            chunks[s] = self._buf[s][:cs]
            self._buf[s] = self._buf[s][cs:]
            self._consumed[s] += cs
        mask = np.zeros(self.slots, bool)
        mask[stepped] = True
        k = self._rows
        outs = []
        for i, part in enumerate(self._parts):   # launch every device
            m, state = part
            new_state, logp = m._step_fn(
                m._weights_dev, state, m.audio_tensor(chunks[i * k:
                                                            (i + 1) * k]))
            keep = mask[i * k:(i + 1) * k]
            if keep.all():
                part[1] = new_state
            else:
                keep = torch.from_numpy(keep).to(m.device)
                part[1] = _map_state(
                    lambda n, o: torch.where(
                        keep.view((-1,) + (1,) * (n.dim() - 1)), n, o),
                    new_state, state)
            outs.append(logp)
        logp = np.concatenate([o.cpu().numpy() for o in outs])
        return {s: self._decode(s, logp[s]) for s in stepped}

    def detach(self, slot: int, total_samples: int | None = None) -> str:
        """Flush ``slot`` through the one-row finish and free it; returns
        the final transcript."""
        if not self._active[slot]:
            raise ValueError(f'slot {slot} is not attached')
        if not self._primed[slot]:
            raise ValueError('detach before prime: stream shorter than the '
                             'prime window; use the offline path')
        tail = self._buf[slot]
        if len(tail) > self.m.chunk_samples:
            raise ValueError(f'slot {slot} has {len(tail)} samples pending '
                             '(> one chunk); tick() until pending() < '
                             'chunk_samples before detaching')
        if total_samples is None:
            total_samples = self._consumed[slot] + len(tail)
        tail_len = total_samples - self._consumed[slot]
        if not 0 <= tail_len <= self.m.chunk_samples:
            raise ValueError('stream end must fall within the final '
                             'partial chunk')
        padded = np.zeros((1, self.m.chunk_samples), np.float32)
        padded[0, :len(tail)] = tail
        m, state = self._parts[slot // self._rows]
        r = slot % self._rows
        row_state = _map_state(lambda s: s[r:r + 1], state)
        logp, valid = m._finish_fn(
            m._weights_dev, row_state, m.audio_tensor(padded),
            torch.tensor([tail_len], dtype=torch.int64, device=m.device))
        self._decode(slot, logp[0, :int(valid[0])].cpu().numpy())
        text = self._text[slot]
        self._active[slot] = False
        return text

    def abort(self, slot: int) -> None:
        """Free ``slot`` without flushing (client vanished / stream too
        short to prime). Safe in every slot state: the next attach resets
        all host bookkeeping and prime overwrites the state rows."""
        self._active[slot] = False

    def text(self, slot: int) -> str:
        return self._text[slot]

    def pending(self, slot: int) -> int:
        """Samples buffered but not yet dispatched for ``slot`` (detach
        requires this to be below one chunk)."""
        return len(self._buf[slot])

    def primed(self, slot: int) -> bool:
        """Whether ``slot``'s stream has filled its prime window."""
        return self._primed[slot]

    # ------------------------------------------------------------------

    def _decode(self, slot: int, logp) -> str:
        """Incremental greedy collapse (repeat state carried per slot)."""
        if logp.shape[0] == 0:
            return ''
        ids = np.argmax(logp, axis=-1)
        out, _, self._last[slot] = greedy_collapse(ids, self._last[slot])
        fresh = ''.join(self.labels[i] for i in out)
        self._text[slot] += fresh
        return fresh
