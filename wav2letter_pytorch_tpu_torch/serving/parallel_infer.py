"""Batched offline inference of a BN-folded stack: the transcription
service regime.

The counterpart of the JAX package's ``serving/parallel_infer.py``: the
folded (or quantized) weights are copied once to each device of a
``parallel.Mesh``; every call splits the audio batch's rows over the
devices, runs the frontend (kernel K1 on the card) and the stack on each
part, launching every part before it fetches any result, and concatenates
the parts in order. Pure data parallelism: no collectives.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..parallel.mesh import Mesh, shard_rows
from ..runtime import resolve_device
from .infer import to_device
from .longform import make_window_forward


class MeshInference:
    """Batched offline inference: the frontend and the folded conv stack,
    one call a batch, over the devices of ``mesh``.

    ``layers``: the layer spec truncated to mid_layers. ``folded``: the
    f32 fold, the int8 weights, or an artifact's. ``frontend``: the
    offline ``SpectrogramFrontend`` (moved to the first device; each
    other device gets its own copy, its tables buffers that move with
    it).
    ``mesh``: a ``parallel.Mesh`` (the batch must divide by its size);
    None serves on ``device`` alone. ``mode``: 'f32' / 'int8' (float32
    math, int8 weights dequantized) or 'int8_full' (int8 activations too,
    which needs quantized weights).
    """

    def __init__(self, layers, folded, frontend, mesh: Mesh | None = None,
                 mode: str = 'f32', padding_mode: str = 'reflect',
                 act_scales=None, device='cuda'):
        if mesh is None:
            mesh = Mesh([resolve_device(device)])
        for d in mesh.devices:
            resolve_device(d)
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.frontend = frontend.to(self.device)
        self._fwd = make_window_forward([dict(l) for l in layers], folded,
                                        mode=mode, padding_mode=padding_mode,
                                        act_scales=act_scales)
        self.weights = to_device(folded, self.device)
        # (frontend, weights) on each device; the first device's are these
        self._parts = [(self.frontend, self.weights)] + [
            (copy.deepcopy(self.frontend).to(d), to_device(folded, d))
            for d in mesh.devices[1:]]

    def logprobs_device(self, audio: torch.Tensor, lengths: torch.Tensor):
        """``audio [B, T_samples]`` and ``lengths [B]`` on the first device
        -> ``(log_probs [B, T', L], out_lengths [B])`` there."""
        with torch.no_grad():
            if self.mesh.size == 1:
                return self._run(0, audio, lengths)
            outs = [self._run(i, a, n) for i, (a, n) in enumerate(
                zip(shard_rows(audio, self.mesh),
                    shard_rows(lengths, self.mesh)))]
            return tuple(torch.cat([o[k].to(self.device) for o in outs])
                         for k in range(2))

    def _run(self, i: int, audio, lengths):
        frontend, weights = self._parts[i]
        feats, flens = frontend(audio, lengths)
        return self._fwd(weights, feats, flens)

    def logprobs(self, audio, lengths):
        """``audio [B, T_samples]``, ``lengths [B]`` (numpy or tensors) ->
        ``(log_probs [B, T', L], out_lengths [B])`` as numpy."""
        audio = torch.as_tensor(np.asarray(audio, np.float32),
                                device=self.device)
        lengths = torch.as_tensor(np.asarray(lengths, np.int32),
                                  device=self.device)
        logp, out_lens = self.logprobs_device(audio, lengths)
        return logp.cpu().numpy(), out_lens.cpu().numpy()

    def transcribe(self, audio, lengths, decoder):
        """Greedy-decode a batch; returns the list of strings."""
        logp, out_lens = self.logprobs(audio, lengths)
        return decoder.decode(logp, sizes=out_lens)
