"""NovoGrad as a ``torch.optim.Optimizer``.

Same update as ``wav2letter_pytorch_tpu.optim.novograd`` (the NVIDIA
NovoGrad of the original recipe), per parameter tensor:

* a **scalar** second moment from the gradient's squared norm: the first
  step copies ``||g||^2``, later ones take ``v <- beta2 * v + (1 - beta2) *
  ||g||^2``;
* with ``amsgrad``, the running maximum of ``v`` is the denominator;
* direction ``d = g / (sqrt(v) + eps)``, plus ``weight_decay * p``, times
  ``1 - beta1`` with ``grad_averaging``;
* momentum ``m <- beta1 * m + d`` and ``p <- p - lr * m``.
"""

from __future__ import annotations

import torch


class Novograd(torch.optim.Optimizer):
    """Layer-wise adaptive NovoGrad. Default betas (0.95, 0)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.95, 0.0),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_averaging: bool = False, amsgrad: bool = False):
        beta1, beta2 = betas
        if not 0.0 <= beta1 < 1.0:
            raise ValueError(f'Invalid beta parameter at index 0: {beta1}')
        if not 0.0 <= beta2 < 1.0:
            raise ValueError(f'Invalid beta parameter at index 1: {beta2}')
        if eps < 0.0:
            raise ValueError(f'Invalid epsilon value: {eps}')
        super().__init__(params, dict(lr=lr, betas=(beta1, beta2), eps=eps,
                                      weight_decay=weight_decay,
                                      grad_averaging=grad_averaging,
                                      amsgrad=amsgrad))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            beta1, beta2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state['exp_avg'] = torch.zeros_like(p)
                    state['exp_avg_sq'] = torch.zeros((), dtype=p.dtype,
                                                      device=p.device)
                    state['max_exp_avg_sq'] = torch.zeros_like(
                        state['exp_avg_sq'])
                v = state['exp_avg_sq']
                norm = torch.sum(g * g)
                # The first step copies the norm (v is still exactly 0).
                v.copy_(torch.where(v == 0, norm, beta2 * v
                                    + (1 - beta2) * norm))
                denom = v
                if group['amsgrad']:
                    vmax = state['max_exp_avg_sq']
                    torch.maximum(vmax, v, out=vmax)
                    denom = vmax
                d = g / (torch.sqrt(denom) + group['eps'])
                if group['weight_decay'] != 0:
                    d = d + group['weight_decay'] * p
                if group['grad_averaging']:
                    d = d * (1 - beta1)
                m = state['exp_avg']
                m.mul_(beta1).add_(d)
                p.add_(m, alpha=-group['lr'])
        return loss
