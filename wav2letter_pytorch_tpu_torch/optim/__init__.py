"""Optimizers and learning-rate schedules.

The JAX package's optax optimizers map onto torch's: ``torch.optim.SGD``
(momentum, Nesterov and *coupled* weight decay, added to the gradient
before the momentum update) is the maths of its ``sgd`` chain
(``add_decayed_weights`` then ``optax.sgd``), and ``torch.optim.AdamW`` of
``optax.adamw``. NovoGrad has no torch counterpart: ``Novograd`` is it.
The learning rate is set on the optimizer's groups before each update from
a schedule (``schedules.py``).
"""

from __future__ import annotations

from .novograd import Novograd
from .schedules import constant_lr, exponential_lr, one_cycle_lr

__all__ = ['Novograd', 'exponential_lr', 'one_cycle_lr', 'constant_lr']
