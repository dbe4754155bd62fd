"""LAMB and Adam as ``torch.optim.Optimizer``s, with optax's arithmetic.

``Lamb`` is the update of ``optax.lamb(lr)``, which optax builds as the
chain ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-6, eps_root=0)`` ->
``add_decayed_weights(0.0)`` -> ``scale_by_trust_ratio()`` -> ``-lr``, per
parameter tensor:

* moments ``m <- (1 - b1) * g + b1 * m``, ``v <- (1 - b2) * g^2 + b2 * v``;
* bias correction by ``1 - b^t`` as optax computes it
  (``_bias_correction``), and direction ``u = m_hat / (sqrt(v_hat) +
  eps)``;
* the trust ratio ``||p|| / ||u||`` of the tensor (1 where either norm is
  0) scales ``u``;
* ``p <- p + (-lr) * u``.

``Adam`` is the same chain without the trust ratio, with eps 1e-8:
``optax.adam(lr)``. ``torch.optim.Adam`` is not it to the
bit: it takes ``1 - b^t`` in float64, which at ``t = 1`` and ``b2 =
0.999`` is 1.3e-5 relative off optax's float32 value, and so moves a
parameter by a different step.

Each operation is written out (no fused ``add_`` with ``alpha``) so the
float32 rounding follows optax's order.
"""

from __future__ import annotations

import numpy as np
import torch

BETA1, BETA2 = 0.9, 0.999   # optax's defaults for adam and lamb


def _bias_correction(b: float, t: int) -> float:
    """``1 - b^t`` as optax's jitted ``tree_bias_correction`` gives it:
    ``b`` rounded to float32, its power rounded to float32 (XLA's float32
    ``pow`` is correctly rounded at these arguments: equal over t < 400 for
    b 0.9 and 0.999), the difference in float32."""
    return float(np.float32(1) - np.float32(float(np.float32(b)) ** t))


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr)``'s update."""

    eps = 1e-8
    trust_ratio = False

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state['step'] = 0
                    state['exp_avg'] = torch.zeros_like(p)
                    state['exp_avg_sq'] = torch.zeros_like(p)
                state['step'] += 1
                t = state['step']
                m, v = state['exp_avg'], state['exp_avg_sq']
                m.copy_((1 - BETA1) * g + BETA1 * m)
                v.copy_((1 - BETA2) * (g * g) + BETA2 * v)
                # A divisor held as a tensor on the parameter's device
                # divides as optax's does (on the card a Python scalar
                # divisor is a multiply by its reciprocal).
                bc1, bc2 = (torch.full((), _bias_correction(b, t),
                                       dtype=torch.float32, device=p.device)
                            for b in (BETA1, BETA2))
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                if self.trust_ratio:
                    p_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(u)
                    u = u * torch.where((p_norm == 0) | (u_norm == 0),
                                        torch.ones_like(p_norm),
                                        p_norm / u_norm)
                p.copy_(p + u * (-group['lr']))
        return loss


class Lamb(Adam):
    """Layer-wise adaptive moments (You et al., 2020): ``optax.lamb(lr)``'s
    update."""

    eps = 1e-6
    trust_ratio = True
