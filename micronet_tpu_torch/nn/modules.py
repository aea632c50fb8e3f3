"""Base modules: the counterpart of ``micronet_tpu/nn/modules.py``.

Only ``Linear`` is ported so far. It keeps the JAX package's (in, out)
weight layout, so weights move between the two packages without a
transpose.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from .._device import resolve_device

__all__ = ["Linear"]


class Linear(nn.Module):
    """Dense layer ``x @ weight (+ bias)`` with weight (in, out), both
    drawn uniform in +-1/sqrt(in) from ``generator``."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        device: Union[str, torch.device, None] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / math.sqrt(in_features)

        def uniform(shape):
            u = torch.rand(shape, generator=generator, device=dev)
            return nn.Parameter(u * (2 * bound) - bound)

        self.weight = uniform((in_features, out_features))
        self.bias = uniform((out_features,)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(torch.float32) @ self.weight.to(torch.float32)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)
