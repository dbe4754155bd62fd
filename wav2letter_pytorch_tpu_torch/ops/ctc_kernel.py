"""K2: CTC forward (alpha) recursion, as a CUDA kernel and in plain PyTorch.

Replaces the forward of ``wav2letter_pytorch_tpu/ops/ctc_pallas.py::
ctc_loss_pallas`` (``_alpha_pass``). ``ctc_alpha`` launches
``csrc/ctc_alpha.cu`` for a CUDA tensor and runs ``ctc_alpha_reference``
for a CPU tensor; it never falls back from one to the other.
``ctc_alpha.launches`` counts kernel launches. There is no backward yet
(kernel K3 comes with training), so an input that requires grad raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ctc import ctc_forward_alphas, read_neg_log_likelihood, reduce_ctc


def ctc_alpha_reference(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                        targets: torch.Tensor, target_lengths: torch.Tensor,
                        blank: int = 0) -> torch.Tensor:
    """Plain version: per-sample -log Z [B] (no zero_infinity), in the
    dtype of ``log_probs``."""
    final = ctc_forward_alphas(log_probs, logit_lengths, targets,
                               target_lengths, blank)
    return read_neg_log_likelihood(final, target_lengths)


def _launch(log_probs, logit_lengths, targets, target_lengths, blank):
    B, T, L = log_probs.shape
    S = targets.shape[1]
    dev = log_probs.device
    if log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError('ctc_alpha: log_probs must be contiguous float32, '
                         f'got {log_probs.dtype}')
    for name, t, shape in (('logit_lengths', logit_lengths, (B,)),
                           ('targets', targets, (B, S)),
                           ('target_lengths', target_lengths, (B,))):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f'ctc_alpha: {name} must be int32 on {dev}, '
                             f'got {t.dtype} on {t.device}')
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'ctc_alpha: {name} must be contiguous with '
                             f'shape {shape}, got {tuple(t.shape)}')
    if T < 1 or not 0 <= blank < L:
        raise ValueError(f'ctc_alpha: need T >= 1 and 0 <= blank < L, got '
                         f'T={T}, blank={blank}, L={L}')
    lib = _build.load('ctc_alpha')
    lib.ctc_alpha_smem_bytes.restype = ctypes.c_longlong
    lib.ctc_alpha_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = lib.ctc_alpha_smem_bytes(S, L)
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(f'ctc_alpha: S={S}, L={L} need {smem} bytes of '
                         f'shared memory, over the limit of '
                         f'{_build.SMEM_LIMIT_BYTES}')
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = lib.ctc_alpha_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(log_probs.data_ptr(), B, T, L, logit_lengths.data_ptr(),
                  targets.data_ptr(), S, target_lengths.data_ptr(), blank,
                  nll.data_ptr(), stream)
    _build.check(lib, code, 'ctc_alpha launch')
    ctc_alpha.launches += 1
    return nll


def ctc_alpha(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
              targets: torch.Tensor, target_lengths: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """Per-sample -log p(target | log_probs[:logit_length]) [B], before
    zero_infinity. ``log_probs`` [B, T, L] batch-first; ``targets`` [B, S]
    zero-padded. On CUDA every input is int32/float32 and contiguous."""
    if log_probs.requires_grad:
        raise NotImplementedError(
            'ctc_alpha has no backward yet: call it under torch.no_grad()')
    if log_probs.device.type == 'cuda':
        return _launch(log_probs, logit_lengths, targets, target_lengths,
                       blank)
    if log_probs.device.type != 'cpu':
        raise ValueError(f'ctc_alpha: unsupported device {log_probs.device}')
    return ctc_alpha_reference(log_probs, logit_lengths, targets,
                               target_lengths, blank)


ctc_alpha.launches = 0


def ctc_loss_kernel(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                    targets: torch.Tensor, target_lengths: torch.Tensor,
                    blank: int = 0, reduction: str = 'mean',
                    zero_infinity: bool = True):
    """``ops.ctc.ctc_loss`` with the recursion done by ``ctc_alpha``."""
    nll = ctc_alpha(log_probs, logit_lengths, targets, target_lengths, blank)
    return reduce_ctc(nll, target_lengths, reduction, zero_infinity)
