"""Adam with optax's arithmetic: the optimizer of the JAX package's
trainer, ``optax.adam``, or ``optax.adamw`` (decoupled weight decay) when
``weight_decay`` is set.

``torch.optim.Adam`` and ``AdamW`` compute the same update in other
roundings: optax updates ``nu`` with ``1 - b2`` taken in f64 but divides
by the bias correction ``1 - b2^t`` taken in f32 (1.3e-5 off in the first
step), so its first update is ``0.9999933 * lr``, theirs ``lr``. This
class does optax's f32 operations in its order, so the updates agree to
an ulp or two:

    mu = (1 - b1) * g + b1 * mu;   nu = (1 - b2) * g^2 + b2 * nu
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)  [+ weight_decay * p]
    p = p + (-lr) * u

Weight decay is decoupled, as in ``optax.adamw`` (never ``Adam``'s L2 on
the gradient), and reaches every parameter, as optax applies no mask.
The state per parameter is optax's: ``mu``, ``nu`` and ``count``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Adam"]


def _bias_correction(b: float, t: int) -> float:
    """``1 - b^t`` as optax takes it: ``b`` in f32, its power rounded once
    to f32 (XLA's f32 pow is correctly rounded), the difference exact."""
    return float(np.float32(1.0) - np.float32(np.float64(np.float32(b)) ** t))


class Adam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    st["count"] = torch.zeros((), dtype=torch.int32)
                st["count"] += 1
                t = int(st["count"])
                mu = st["mu"].mul_(b1).add_(g * (1 - b1))
                nu = st["nu"].mul_(b2).add_((g * g) * (1 - b2))
                u = ((mu / _bias_correction(b1, t))
                     / (torch.sqrt(nu / _bias_correction(b2, t)) + eps))
                if wd:
                    u = u + wd * p
                p.add_(u * -group["lr"])
        return loss
