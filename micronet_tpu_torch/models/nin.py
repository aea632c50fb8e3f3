"""Network-in-Network for CIFAR-10: the counterpart of
``micronet_tpu/models/nin.py``. Nine Conv + BN + ReLU blocks with
``cfg``-driven widths, two max-pools (3, stride 2, padding 1), a 10-way
1x1-conv classifier and an 8x8 average pool. ``Net.forward`` takes NHWC
images and runs NCHW inside.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .._device import resolve_device
from ..nn import modules as M

__all__ = ["DEFAULT_CFG", "ConvBNReLU", "Net"]

DEFAULT_CFG = [192, 160, 96, 192, 192, 192, 192, 192]


class ConvBNReLU(nn.Module):
    """Conv + BN + ReLU; BN fusion pairs the conv with the BN after it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, groups: int = 1, bias: bool = True,
                 eps: float = 1e-5, momentum: float = 0.1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = M.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                             padding=padding, dilation=dilation, groups=groups, bias=bias,
                             device=device, generator=generator)
        self.bn = M.BatchNorm2d(out_channels, eps=eps, momentum=momentum, device=device)
        self.relu = M.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.relu(self.bn(self.conv(x)))


class Net(nn.Module):
    """NIN: NHWC images (N, 32, 32, 3) in, logits out. ``device`` None
    means CUDA (raises without a card)."""

    def __init__(self, cfg: Optional[Sequence[int]] = None, num_classes: int = 10, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = list(DEFAULT_CFG if cfg is None else cfg)
        kw = dict(device=resolve_device(device), generator=generator)
        self.cfg = cfg
        self.model = M.Sequential(
            ConvBNReLU(3, cfg[0], kernel_size=5, stride=1, padding=2, **kw),
            ConvBNReLU(cfg[0], cfg[1], kernel_size=1, **kw),
            ConvBNReLU(cfg[1], cfg[2], kernel_size=1, **kw),
            M.MaxPool2d(kernel_size=3, stride=2, padding=1),
            ConvBNReLU(cfg[2], cfg[3], kernel_size=5, stride=1, padding=2, **kw),
            ConvBNReLU(cfg[3], cfg[4], kernel_size=1, **kw),
            ConvBNReLU(cfg[4], cfg[5], kernel_size=1, **kw),
            M.MaxPool2d(kernel_size=3, stride=2, padding=1),
            ConvBNReLU(cfg[5], cfg[6], kernel_size=3, stride=1, padding=1, **kw),
            ConvBNReLU(cfg[6], cfg[7], kernel_size=1, **kw),
            ConvBNReLU(cfg[7], num_classes, kernel_size=1, **kw),
            M.AvgPool2d(kernel_size=8, stride=1, padding=0),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.model(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        return x.reshape(x.shape[0], -1)
