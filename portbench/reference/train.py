"""Plain PyTorch reference of one QAT training step: CIFAR augmentation
(zero padding of 4, a 32 x 32 crop, a horizontal flip, normalization to
mean and std 0.5), the mean cross-entropy, autograd's backward through
:class:`.iao.IaoNet`, and Adam with decoupled weight decay (Kingma and
Ba; Loshchilov and Hutter):

    mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g^2
    p -= lr * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as TF

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def augment(images_u8: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """NHWC uint8 images -> the normalized crops at ``offsets`` (rows,
    columns in 0..8 of the zero-padded image), flipped where ``flips``."""
    n = images_u8.shape[0]
    padded = torch.zeros((n, 40, 40, 3), dtype=dtype, device=images_u8.device)
    padded[:, 4:36, 4:36] = images_u8.to(dtype)
    # one correctly rounded division: a pixel's value can sit exactly on a
    # code's rounding edge, so a product by 1/255 would move codes
    x = (padded / torch.tensor(255.0, dtype=dtype, device=padded.device) - 0.5) / 0.5
    out = torch.empty((n, 32, 32, 3), dtype=dtype, device=images_u8.device)
    rows, cols = offsets[:, 0].tolist(), offsets[:, 1].tolist()
    for i in range(n):
        out[i] = x[i, rows[i]:rows[i] + 32, cols[i]:cols[i] + 32]
    return torch.where(flips[:, None, None, None], out.flip(2), out)


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + ADAM_EPS) + self.wd * p
            p -= self.lr * u


def run_steps(net, batches: List[tuple], lr: float, weight_decay: float,
              loss_rows: Optional[int] = None) -> dict:
    """Train ``net`` (an :class:`.iao.IaoNet`) one step per ``(images_u8,
    labels, offsets, flips)`` batch. Returns each step's loss, each leaf's
    first gradient and each leaf's change over all the steps. With
    ``loss_rows`` the loss is the mean over the batch's first rows only
    (the forward, and so the batch statistics, still see every row)."""
    opt = AdamW(net.params, lr, weight_decay)
    start = {k: p.detach().clone() for k, p in net.params.items()}
    losses, first_grad = [], None
    for images, labels, offsets, flips in batches:
        x = augment(images, offsets, flips, net.dtype)
        logits = net(x, train=True)
        loss = TF.cross_entropy(logits[:loss_rows], labels[:loss_rows])
        grads = dict(zip(net.params, torch.autograd.grad(loss, list(net.params.values()))))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    delta = {k: (p.detach() - start[k]) for k, p in net.params.items()}
    return dict(losses=losses, grad=first_grad, delta=delta)
