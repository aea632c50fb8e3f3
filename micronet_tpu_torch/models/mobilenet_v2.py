"""MobileNetV2 (Sandler et al., "MobileNetV2: Inverted Residuals and
Linear Bottlenecks", arXiv:1801.04381, Table 2) for 32 x 32 images.

The published widths, expansion factors, block counts and ReLU6s: a
32-channel 3 x 3 stem, seven stages of inverted residuals (t, c, n, s) =
(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
(6, 160, 3, 2), (6, 320, 1, 1), a 1 x 1 head to 1,280 and a linear
classifier. An inverted residual is a 1 x 1 expansion to t * c_in
channels with ReLU6 (none where t = 1), a 3 x 3 depthwise conv (groups =
channels) with ReLU6, and a linear 1 x 1 projection; where the stride is
1 and c_in = c_out, an identity add with no activation after it (the
linear bottleneck), through :class:`..nn.modules.Add`, so ``prepare``
swaps in ``QuantAdd``.

Departures from the published net, for CIFAR-sized inputs:

- the strides (the stem's, then each stage's first block's) are
  :data:`CIFAR_STRIDES`: the stem and the c = 24 stage run at stride 1, so
  32 x 32 ends at 4 x 4 as 224 x 224 ends at 7 x 7 (the published ones
  are (2, 1, 2, 2, 2, 1, 2, 1));
- the classifier's Dropout(0.2), the identity at inference, is left out;
- the global average pool is a module (``avgpool``), so that it quantizes.

Module names follow torchvision's ``mobilenet_v2`` where the port's
modules allow: ``features`` holds the stem, the 17 blocks and the head
(a ``Sequential`` keeps its children in ``layers``, so torchvision's
``features.1.conv.0.0.weight`` is ``features.layers.1.conv.layers.0.layers.0.weight``);
``classifier`` is the linear layer itself. ``forward`` takes NHWC images,
as the other models do, and runs NCHW inside.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .._device import resolve_device
from ..nn import modules as M

__all__ = ["InvertedResidual", "MobileNetV2", "mobilenet_v2", "SETTINGS", "WIDTHS",
           "CIFAR_STRIDES"]

# (expansion t, repeats n) of each stage (Table 2)
SETTINGS = ((1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1))
# the stem's width, each stage's c, the head's width
WIDTHS = (32, 16, 24, 32, 64, 96, 160, 320, 1280)
# the stem's stride, then each stage's s, cut for 32 x 32 inputs
CIFAR_STRIDES = (1, 1, 1, 2, 2, 1, 2, 1)


def _conv_bn_act(cin: int, cout: int, k: int, stride: int, groups: int, kw) -> M.Sequential:
    """torchvision's ``Conv2dNormActivation``: conv (no bias), BN, ReLU6."""
    return M.Sequential(
        M.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, groups=groups, bias=False,
                 **kw),
        M.BatchNorm2d(cout, device=kw["device"]),
        M.ReLU6(),
    )


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        hidden = cin * expand
        layers = [] if expand == 1 else [_conv_bn_act(cin, hidden, 1, 1, 1, kw)]
        layers += [
            _conv_bn_act(hidden, hidden, 3, stride, hidden, kw),
            M.Conv2d(hidden, cout, 1, bias=False, **kw),
            M.BatchNorm2d(cout, device=device),
        ]
        self.conv = M.Sequential(*layers)
        self.use_res_connect = stride == 1 and cin == cout
        if self.use_res_connect:
            self.add = M.Add()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_res_connect:
            return self.add(self.conv(x), x)
        return self.conv(x)


class MobileNetV2(nn.Module):
    """NHWC images (N, 32, 32, 3) in, logits out. ``device`` None means
    CUDA (raises without a card)."""

    def __init__(self, num_classes: int = 10, *, widths: Sequence[int] = WIDTHS, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        stem, *stages, head = widths
        layers = [_conv_bn_act(3, stem, 3, CIFAR_STRIDES[0], 1, kw)]
        cin = stem
        for (t, n), c, s in zip(SETTINGS, stages, CIFAR_STRIDES[1:]):
            for i in range(n):
                layers.append(InvertedResidual(cin, c, s if i == 0 else 1, t, **kw))
                cin = c
        layers.append(_conv_bn_act(cin, head, 1, 1, 1, kw))
        self.features = M.Sequential(*layers)
        self.avgpool = M.AdaptiveAvgPool2d((1, 1))
        self.classifier = M.Linear(head, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.avgpool(self.features(x.permute(0, 3, 1, 2)))  # NHWC -> NCHW
        return self.classifier(out.reshape(out.shape[0], -1))


def mobilenet_v2(num_classes: int = 10, *, widths: Sequence[int] = WIDTHS, device=None,
                 generator: Optional[torch.Generator] = None) -> MobileNetV2:
    """MobileNetV2 with the CIFAR strides, at the published widths unless
    ``widths`` (the stem's, each stage's c, the head's) says otherwise."""
    return MobileNetV2(num_classes, widths=widths, device=device, generator=generator)
