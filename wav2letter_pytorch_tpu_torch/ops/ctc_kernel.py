"""K2 and K3: the CTC forward (alpha) and backward (beta) recursions, as
CUDA kernels and in plain PyTorch, joined by an autograd Function.

Replaces ``wav2letter_pytorch_tpu/ops/ctc_pallas.py::ctc_loss_pallas``:
``ctc_alpha`` launches ``csrc/ctc_alpha.cu`` (K2, ``_alpha_pass``) and
``ctc_beta`` launches ``csrc/ctc_beta.cu`` (K3, ``_ctc_logz_bwd``) for
CUDA tensors, and run their plain versions (``ops/ctc.py``) for CPU
tensors; neither ever falls back from one to the other. ``CTCLoss`` is the
``custom_vjp`` of the JAX package: its forward is K2 storing every step's
alphas (the residual the TPU kernel keeps too), its backward is K3.
``ctc_alpha.launches`` and ``ctc_beta.launches`` count wrapper calls that
launch: one device launch for K2, two for K3 (the beta chain, then the
per-label gradient sums).

Both kernels hold a row's 2S+1 lattice positions in the registers of one
block (``csrc/ctc_lattice.cuh``); the wrappers raise ``ValueError`` before
launching for a target width S whose lattice does not fit (S > 2047).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ctc import (ctc_beta_reference, ctc_forward_alphas,
                  read_neg_log_likelihood, reduce_ctc)


def ctc_alpha_reference(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                        targets: torch.Tensor, target_lengths: torch.Tensor,
                        blank: int = 0, store_alphas: bool = False):
    """Plain version: per-sample -log Z [B] (no zero_infinity), in the
    dtype of ``log_probs``; with ``store_alphas``, ``(nll, alphas)``,
    alphas [B, T, 2S+1]."""
    out = ctc_forward_alphas(log_probs, logit_lengths, targets,
                             target_lengths, blank, return_all=store_alphas)
    if store_alphas:
        final, alphas = out
        return read_neg_log_likelihood(final, target_lengths), alphas
    return read_neg_log_likelihood(out, target_lengths)


def _check_inputs(name, log_probs, logit_lengths, targets, target_lengths,
                  blank):
    B, T, L = log_probs.shape
    S = targets.shape[1]
    dev = log_probs.device
    if log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError(f'{name}: log_probs must be contiguous float32, '
                         f'got {log_probs.dtype}')
    for what, t, shape in (('logit_lengths', logit_lengths, (B,)),
                           ('targets', targets, (B, S)),
                           ('target_lengths', target_lengths, (B,))):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f'{name}: {what} must be int32 on {dev}, '
                             f'got {t.dtype} on {t.device}')
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'{name}: {what} must be contiguous with '
                             f'shape {shape}, got {tuple(t.shape)}')
    if T < 1 or not 0 <= blank < L:
        raise ValueError(f'{name}: need T >= 1 and 0 <= blank < L, got '
                         f'T={T}, blank={blank}, L={L}')


def _load(name: str, S: int, L: int, warps: int = 0) -> ctypes.CDLL:
    """The kernel's library, after checking that it takes (S, L) at
    ``warps`` warps a row (0: its own table)."""
    lib = _build.load(name)
    smem_fn = getattr(lib, f'{name}_smem_bytes')
    smem_fn.restype = ctypes.c_longlong
    smem_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = smem_fn(S, L)
    if smem > _build.SMEM_LIMIT_BYTES:
        raise ValueError(f'{name}: S={S}, L={L} need {smem} bytes of '
                         f'shared memory, over the limit of '
                         f'{_build.SMEM_LIMIT_BYTES}')
    warps_fn = getattr(lib, f'{name}_warps')
    warps_fn.restype = ctypes.c_int
    warps_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    if warps_fn(S, warps) == 0:
        raise ValueError(f'{name}: S={S} gives {2 * S + 1} lattice '
                         f'positions, more than one block holds in '
                         f'registers at warps={warps or "table"} '
                         f'(csrc/ctc_lattice.cuh::plan_warps)')
    return lib


def _launch_alpha(log_probs, logit_lengths, targets, target_lengths, blank,
                  store_alphas, warps=0):
    _check_inputs('ctc_alpha', log_probs, logit_lengths, targets,
                  target_lengths, blank)
    B, T, L = log_probs.shape
    S = targets.shape[1]
    dev = log_probs.device
    lib = _load('ctc_alpha', S, L, warps)
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    # Only rows t < logit_length and positions s < 2*S_b+1 are written:
    # those are all that K3 reads.
    alphas = (torch.empty((B, T, 2 * S + 1), dtype=torch.float32,
                          device=dev) if store_alphas else None)
    fn = lib.ctc_alpha_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(log_probs.data_ptr(), B, T, L, logit_lengths.data_ptr(),
                  targets.data_ptr(), S, target_lengths.data_ptr(), blank,
                  nll.data_ptr(),
                  alphas.data_ptr() if store_alphas else None, warps, stream)
    _build.check(lib, code, 'ctc_alpha launch')
    ctc_alpha.launches += 1
    return (nll, alphas) if store_alphas else nll


def ctc_alpha(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
              targets: torch.Tensor, target_lengths: torch.Tensor,
              blank: int = 0, store_alphas: bool = False):
    """Per-sample -log p(target | log_probs[:logit_length]) [B], before
    zero_infinity; with ``store_alphas``, ``(nll, alphas [B, T, 2S+1])``
    for ``ctc_beta``. ``log_probs`` [B, T, L] batch-first; ``targets``
    [B, S] zero-padded. On CUDA every input is int32/float32 and
    contiguous. No gradient flows through this function itself: use
    ``CTCLoss`` / ``ctc_loss_kernel``."""
    if log_probs.device.type == 'cuda':
        return _launch_alpha(log_probs.detach(), logit_lengths, targets,
                             target_lengths, blank, store_alphas)
    if log_probs.device.type != 'cpu':
        raise ValueError(f'ctc_alpha: unsupported device {log_probs.device}')
    with torch.no_grad():
        return ctc_alpha_reference(log_probs, logit_lengths, targets,
                                   target_lengths, blank, store_alphas)


ctc_alpha.launches = 0


def _launch_beta(log_probs, alphas, nll, logit_lengths, targets,
                 target_lengths, grad_nll, blank, warps=0):
    _check_inputs('ctc_beta', log_probs, logit_lengths, targets,
                  target_lengths, blank)
    B, T, L = log_probs.shape
    S = targets.shape[1]
    dev = log_probs.device
    for what, t, shape in (('alphas', alphas, (B, T, 2 * S + 1)),
                           ('nll', nll, (B,)), ('grad_nll', grad_nll, (B,))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f'ctc_beta: {what} must be contiguous float32 '
                             f'{shape} on {dev}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    lib = _load('ctc_beta', S, L, warps)
    grad = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    # Scratch: log-beta (written only where the gradient pass reads it)
    # and each row's label positions sorted by label, with offsets.
    beta = torch.empty((B, T, 2 * S + 1), dtype=torch.float32, device=dev)
    order = torch.empty((B, S + L + 1), dtype=torch.int32, device=dev)
    fn = lib.ctc_beta_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(log_probs.data_ptr(), B, T, L, alphas.data_ptr(),
                  nll.data_ptr(), grad_nll.data_ptr(),
                  logit_lengths.data_ptr(), targets.data_ptr(), S,
                  target_lengths.data_ptr(), blank, grad.data_ptr(),
                  beta.data_ptr(), order.data_ptr(), warps, stream)
    _build.check(lib, code, 'ctc_beta launch')
    ctc_beta.launches += 1
    return grad


def ctc_beta(log_probs: torch.Tensor, alphas: torch.Tensor,
             neg_log_lik: torch.Tensor, logit_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             grad_nll: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """d(loss)/d``log_probs`` [B, T, L] from ``ctc_alpha(...,
    store_alphas=True)``'s ``(neg_log_lik, alphas)`` and the upstream
    gradient ``grad_nll`` [B] of each row's nll (see
    ``ops.ctc.ctc_beta_reference``)."""
    if log_probs.device.type == 'cuda':
        return _launch_beta(log_probs, alphas, neg_log_lik, logit_lengths,
                            targets, target_lengths, grad_nll, blank)
    if log_probs.device.type != 'cpu':
        raise ValueError(f'ctc_beta: unsupported device {log_probs.device}')
    return ctc_beta_reference(log_probs, alphas, neg_log_lik, logit_lengths,
                              targets, target_lengths, grad_nll, blank)


ctc_beta.launches = 0


class CTCLoss(torch.autograd.Function):
    """Per-sample CTC nll [B] (before zero_infinity) with a gradient with
    respect to ``log_probs``: forward K2 (alphas stored), backward K3."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, targets, target_lengths,
                blank: int = 0):
        nll, alphas = ctc_alpha(log_probs, logit_lengths, targets,
                                target_lengths, blank, store_alphas=True)
        ctx.blank = blank
        ctx.save_for_backward(log_probs, alphas, nll, logit_lengths,
                              targets, target_lengths)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        log_probs, alphas, nll, logit_lengths, targets, target_lengths = \
            ctx.saved_tensors
        grad = ctc_beta(log_probs.detach(), alphas, nll, logit_lengths,
                        targets, target_lengths,
                        grad_nll.to(log_probs.dtype).contiguous(), ctx.blank)
        return grad, None, None, None, None


def ctc_loss_kernel(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                    targets: torch.Tensor, target_lengths: torch.Tensor,
                    blank: int = 0, reduction: str = 'mean',
                    zero_infinity: bool = True):
    """``ops.ctc.ctc_loss`` with the recursions done by K2 and, when
    ``log_probs`` requires a gradient, K3."""
    if log_probs.requires_grad and torch.is_grad_enabled():
        nll = CTCLoss.apply(log_probs, logit_lengths, targets,
                            target_lengths, blank)
    else:
        nll = ctc_alpha(log_probs, logit_lengths, targets, target_lengths,
                        blank)
    return reduce_ctc(nll, target_lengths, reduction, zero_infinity)
