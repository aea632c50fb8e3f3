"""Small LeNet-style net of the package self-test: the counterpart of
``micronet_tpu/models/lenet.py``. ``LeNet.forward`` takes NHWC images
(N, 32, 32, 3) and runs NCHW inside; its ``Flatten`` flattens in NHWC
order, so ``classifier`` takes the JAX package's (in, out) weights.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import resolve_device
from ..nn import modules as M

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """conv-BN-ReLU-pool twice, then three Linear layers. ``device`` None
    means CUDA (raises without a card)."""

    def __init__(self, num_classes: int = 10, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.features = M.Sequential(
            M.Conv2d(3, 6, 5, **kw),
            M.BatchNorm2d(6, device=dev),
            M.ReLU(),
            M.MaxPool2d(2, 2),
            M.Conv2d(6, 16, 5, **kw),
            M.BatchNorm2d(16, device=dev),
            M.ReLU(),
            M.MaxPool2d(2, 2),
        )
        self.flatten = M.Flatten()
        self.classifier = M.Sequential(
            M.Linear(16 * 5 * 5, 120, **kw),
            M.ReLU(),
            M.Linear(120, 84, **kw),
            M.ReLU(),
            M.Linear(84, num_classes, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        return self.classifier(self.flatten(x))
