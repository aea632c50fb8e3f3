"""CIFAR ResNet-18/34/50/101/152: the counterpart of
``micronet_tpu/models/resnet.py``.

``ResNet.forward`` takes NHWC images, as the JAX model does, and runs
NCHW inside. Residual adds go through :class:`..nn.modules.Add`, so
``prepare`` swaps in ``QuantAdd`` with its union scale. The ReLU after
each add is a bare function, never a child module, so it is never
rewritten (and breaks int8 chaining in the engine, as in the JAX
package).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import resolve_device
from ..nn import modules as M

__all__ = ["BasicBlock", "BottleNeck", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        out = out_channels * BasicBlock.expansion
        self.residual_function = M.Sequential(
            M.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1, **kw),
            M.BatchNorm2d(out_channels, device=device),
            M.ReLU(),
            M.Conv2d(out_channels, out, 3, padding=1, **kw),
            M.BatchNorm2d(out, device=device),
        )
        if stride != 1 or in_channels != out:
            self.shortcut = M.Sequential(
                M.Conv2d(in_channels, out, 1, stride=stride, **kw),
                M.BatchNorm2d(out, device=device),
            )
        else:
            self.shortcut = M.Sequential()
        self.add = M.Add()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.add(self.residual_function(x), self.shortcut(x)))


class BottleNeck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        out = out_channels * BottleNeck.expansion
        self.residual_function = M.Sequential(
            M.Conv2d(in_channels, out_channels, 1, **kw),
            M.BatchNorm2d(out_channels, device=device),
            M.ReLU(),
            M.Conv2d(out_channels, out_channels, 3, stride=stride, padding=1, **kw),
            M.BatchNorm2d(out_channels, device=device),
            M.ReLU(),
            M.Conv2d(out_channels, out, 1, **kw),
            M.BatchNorm2d(out, device=device),
        )
        if stride != 1 or in_channels != out:
            self.shortcut = M.Sequential(
                M.Conv2d(in_channels, out, 1, stride=stride, **kw),
                M.BatchNorm2d(out, device=device),
            )
        else:
            self.shortcut = M.Sequential()
        self.add = M.Add()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.add(self.residual_function(x), self.shortcut(x)))


class ResNet(nn.Module):
    """CIFAR ResNet: NHWC images (N, 32, 32, 3) in, logits out. ``device``
    None means CUDA (raises without a card)."""

    def __init__(self, block, num_block, num_classes: int = 10, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.in_channels = 64
        self.conv1 = M.Sequential(
            M.Conv2d(3, 64, 3, padding=1, bias=False, **kw),
            M.BatchNorm2d(64, device=dev),
            M.ReLU(),
        )
        self.conv2_x = self._make_layer(block, 64, num_block[0], 1, kw)
        self.conv3_x = self._make_layer(block, 128, num_block[1], 2, kw)
        self.conv4_x = self._make_layer(block, 256, num_block[2], 2, kw)
        self.conv5_x = self._make_layer(block, 512, num_block[3], 2, kw)
        self.avg_pool = M.AdaptiveAvgPool2d((1, 1))
        self.fc = M.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, out_channels, num_blocks, stride, kw):
        layers = []
        for s in [stride] + [1] * (num_blocks - 1):
            layers.append(block(self.in_channels, out_channels, s, **kw))
            self.in_channels = out_channels * block.expansion
        return M.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        out = self.conv2_x(out)
        out = self.conv3_x(out)
        out = self.conv4_x(out)
        out = self.conv5_x(out)
        out = self.avg_pool(out)
        return self.fc(out.reshape(out.shape[0], -1))


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BottleNeck, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BottleNeck, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BottleNeck, [3, 8, 36, 3], num_classes, **kw)
