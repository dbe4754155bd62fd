"""CTC loss as a plain log-space alpha recursion, batch-first.

Same semantics as ``wav2letter_pytorch_tpu/ops/ctc.py`` (torch
``nn.CTCLoss(blank, reduction, zero_infinity)``): per-sample loss is
-log p(target | log_probs[:logit_length]); impossible alignments come out
near +1e30 (``NEG_INF`` is finite) and ``zero_infinity`` zeroes anything
at or above 0.5e30; 'mean' divides each loss by max(target_length, 1) and
averages over the batch.

This is the plain version of kernels K2 (``ctc_forward_alphas``) and K3
(``ctc_beta_reference``) of ``ops/ctc_kernel.py``: Python loops over time,
run on whatever device their inputs are on.
"""

from __future__ import annotations

import torch

# Large-but-finite stand-in for -inf, as in the JAX package: logaddexp of
# two of them stays finite.
NEG_INF = -1e30


def _extend_targets(targets: torch.Tensor, blank: int):
    """Interleave blanks: targets [B, S] -> ext [B, 2S+1] plus skip mask.

    ext[2i] = blank, ext[2i+1] = targets[i]. ``allow_skip[s]`` is True
    where the recursion may take the two-step transition s-2 -> s: at label
    positions whose label differs from the previous label (never at s=1).
    """
    B, S = targets.shape
    ext = torch.full((B, 2 * S + 1), blank, dtype=targets.dtype,
                     device=targets.device)
    ext[:, 1::2] = targets
    prev_label = torch.cat(
        [torch.full((B, 1), blank - 1, dtype=targets.dtype,
                    device=targets.device), targets[:, :-1]], dim=1)
    allow_skip = torch.zeros((B, 2 * S + 1), dtype=torch.bool,
                             device=targets.device)
    allow_skip[:, 1::2] = targets != prev_label
    allow_skip[:, 1] = False
    return ext, allow_skip


def ctc_forward_alphas(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                       targets: torch.Tensor, target_lengths: torch.Tensor,
                       blank: int = 0, return_all: bool = False):
    """Alpha recursion; returns the final alphas [B, 2S+1]: row b holds
    log alpha at step ``logit_lengths[b] - 1`` (updates freeze once t
    passes each sample's length). With ``return_all``, returns
    ``(final, alphas)`` where ``alphas`` [B, T, 2S+1] holds every step's
    alphas (rows past a sample's length repeat its final alphas).
    """
    B, T, _ = log_probs.shape
    targets = targets.to(torch.int64)
    ext, allow_skip = _extend_targets(targets, blank)
    N = ext.shape[1]
    logit_lengths = logit_lengths.to(device=log_probs.device)
    target_lengths = target_lengths.to(device=log_probs.device)

    def gather_ext(lp_t):
        return torch.gather(lp_t, 1, ext)

    lp0 = gather_ext(log_probs[:, 0])
    alpha = torch.full((B, N), NEG_INF, dtype=log_probs.dtype,
                       device=log_probs.device)
    alpha[:, 0] = lp0[:, 0]
    if N > 1:
        # Entering the first label is only legal for a non-empty target.
        alpha[:, 1] = torch.where(target_lengths > 0, lp0[:, 1],
                                  torch.full_like(lp0[:, 1], NEG_INF))
    neg = torch.full((B, 1), NEG_INF, dtype=log_probs.dtype,
                     device=log_probs.device)
    every = [alpha]
    for t in range(1, T):
        lp_ext = gather_ext(log_probs[:, t])
        shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        shift2 = torch.where(allow_skip, shift2, torch.full_like(shift2,
                                                                 NEG_INF))
        new = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) + lp_ext
        alpha = torch.where((t < logit_lengths)[:, None], new, alpha)
        every.append(alpha)
    if return_all:
        return alpha, torch.stack(every, dim=1)
    return alpha


def ctc_beta_reference(log_probs: torch.Tensor, alphas: torch.Tensor,
                       neg_log_lik: torch.Tensor, logit_lengths: torch.Tensor,
                       targets: torch.Tensor, target_lengths: torch.Tensor,
                       grad_nll: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Plain version of kernel K3: d(loss)/d``log_probs`` [B, T, L] for a
    per-sample loss ``neg_log_lik`` [B] (= -log Z, from the alphas
    [B, T, 2S+1] of ``ctc_forward_alphas(..., return_all=True)``) with
    upstream gradient ``grad_nll`` [B].

    Reverse recursion from each row's last frame ``logit_lengths[b] - 1``:
    beta starts at 0 on the read positions (final blank 2S_b, final label
    2S_b - 1 when S_b > 0) and
    ``beta_t[s] = logaddexp(logaddexp(beta_{t+1}[s] + e_{t+1}(s),
    beta_{t+1}[s+1] + e_{t+1}(s+1)), skip[s+2] ? beta_{t+1}[s+2] +
    e_{t+1}(s+2) : NEG_INF)``. The occupation posterior
    ``gamma_t(s) = exp(alpha_t(s) + beta_t(s) + nll)`` is d log Z / d
    e_t(s); summed over the lattice positions of each label it gives
    d log Z / d log_probs[t, label], and the result is ``-grad_nll`` times
    that. Frames at or past a row's length get zero, and so does every
    frame of a row whose ``grad_nll`` is 0 (a ``zero_infinity`` row):
    gamma is never multiplied into 0 * inf.
    """
    B, T, L = log_probs.shape
    dev, dtype = log_probs.device, log_probs.dtype
    targets = targets.to(device=dev, dtype=torch.int64)
    ext, allow_skip = _extend_targets(targets, blank)
    N = ext.shape[1]
    tl = target_lengths.to(device=dev, dtype=torch.int64)
    last = torch.clamp(logit_lengths.to(device=dev, dtype=torch.int64),
                       1, T) - 1
    pos = torch.arange(N, device=dev)[None, :]
    final_sel = (pos == 2 * tl[:, None]) | ((pos == 2 * tl[:, None] - 1)
                                            & (tl > 0)[:, None])
    beta = torch.where(final_sel, torch.zeros((), dtype=dtype, device=dev),
                       torch.full((), NEG_INF, dtype=dtype, device=dev))
    logz = -neg_log_lik.to(dtype)
    live = (grad_nll != 0).to(device=dev)
    neg = torch.full((B, 1), NEG_INF, dtype=dtype, device=dev)
    neg_b = torch.full_like(beta, NEG_INF)
    grad = torch.zeros((B, T, L), dtype=dtype, device=dev)
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            u = beta + torch.gather(log_probs[:, t + 1], 1, ext)
            s1 = torch.cat([u[:, 1:], neg], dim=1)
            s2 = torch.cat([torch.where(allow_skip, u, neg_b)[:, 2:], neg,
                            neg], dim=1)
            new = torch.logaddexp(torch.logaddexp(u, s1), s2)
            beta = torch.where((t < last)[:, None], new, beta)
        gamma = torch.exp(alphas[:, t] + beta - logz[:, None])
        gamma = torch.where(((t <= last) & live)[:, None], gamma,
                            torch.zeros_like(gamma))
        grad[:, t] = torch.zeros((B, L), dtype=dtype, device=dev).scatter_add(
            1, ext, gamma)
    return -(grad_nll.to(dtype)[:, None, None] * grad)


def read_neg_log_likelihood(final: torch.Tensor,
                            target_lengths: torch.Tensor) -> torch.Tensor:
    """-log Z from final alphas: log-sum of the final blank (2S) and the
    final label (2S-1, only for a non-empty target)."""
    tl = target_lengths.to(device=final.device, dtype=torch.int64)
    a_blank = torch.gather(final, 1, (2 * tl)[:, None])[:, 0]
    label_pos = torch.clamp(2 * tl - 1, min=0)[:, None]
    a_label = torch.gather(final, 1, label_pos)[:, 0]
    a_label = torch.where(tl > 0, a_label, torch.full_like(a_label, NEG_INF))
    return -torch.logaddexp(a_blank, a_label)


def reduce_ctc(neg_log_lik: torch.Tensor, target_lengths: torch.Tensor,
               reduction: str = 'mean', zero_infinity: bool = True):
    """zero_infinity, then reduction 'none' | 'sum' | 'mean'."""
    if zero_infinity:
        impossible = neg_log_lik >= -0.5 * NEG_INF
        neg_log_lik = torch.where(impossible, torch.zeros_like(neg_log_lik),
                                  neg_log_lik)
    if reduction == 'none':
        return neg_log_lik
    if reduction == 'sum':
        return torch.sum(neg_log_lik)
    if reduction == 'mean':
        denom = torch.clamp(target_lengths.to(neg_log_lik.device), min=1)
        return torch.mean(neg_log_lik / denom.to(neg_log_lik.dtype))
    raise ValueError(f'unknown reduction: {reduction!r}')


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0, reduction: str = 'mean',
             zero_infinity: bool = True):
    """CTC loss of batch-first ``log_probs`` [B, T, L] against zero-padded
    ``targets`` [B, S]. Scalar for 'mean'/'sum', [B] for 'none'."""
    final = ctc_forward_alphas(log_probs, logit_lengths, targets,
                               target_lengths, blank)
    nll = read_neg_log_likelihood(final, target_lengths)
    return reduce_ctc(nll, target_lengths, reduction, zero_infinity)
