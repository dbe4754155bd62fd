"""Batched offline inference of a BN-folded stack: the transcription
service regime.

The counterpart of the JAX package's ``serving/parallel_infer.py``. There
the batch is sharded over a device mesh; here it runs on one device. Data
parallelism over several GPUs is ROADMAP A.9.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import resolve_device
from .infer import to_device
from .longform import make_window_forward


class MeshInference:
    """Batched offline inference: the frontend (kernel K1 on the card) and
    the folded conv stack, one call a batch.

    ``layers``: the layer spec truncated to mid_layers. ``folded``: the
    f32 fold, the int8 weights, or an artifact's. ``frontend``: the
    offline ``SpectrogramFrontend`` (moved to ``device``). ``mode``:
    'f32' / 'int8' (float32 math, int8 weights dequantized) or 'int8_full'
    (int8 activations too, which needs quantized weights). The weights are
    copied to ``device`` once.
    """

    def __init__(self, layers, folded, frontend, mode: str = 'f32',
                 padding_mode: str = 'reflect', act_scales=None,
                 device='cuda'):
        self.device = resolve_device(device)
        self.frontend = frontend.to(self.device)
        self._fwd = make_window_forward([dict(l) for l in layers], folded,
                                        mode=mode, padding_mode=padding_mode,
                                        act_scales=act_scales)
        self.weights = to_device(folded, self.device)

    def logprobs_device(self, audio: torch.Tensor, lengths: torch.Tensor):
        """``audio [B, T_samples]`` and ``lengths [B]`` on the device ->
        ``(log_probs [B, T', L], out_lengths [B])`` on the device."""
        with torch.no_grad():
            feats, flens = self.frontend(audio, lengths)
            return self._fwd(self.weights, feats, flens)

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
