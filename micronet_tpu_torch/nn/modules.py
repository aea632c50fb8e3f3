"""Base modules: the counterpart of ``micronet_tpu/nn/modules.py``.

``Linear`` keeps the JAX package's (in, out) weight layout. Convolutions
run NCHW activations against OIHW kernels (the JAX package's HWIO
kernels transpose on the way in, ``interop.py``). ``Sequential`` keeps
its children in a ``layers`` list, so a parameter's ``state_dict`` key is
the JAX package's state path joined with dots
(``conv1.layers.0.weight``). Child order is insertion order, which is
what Conv -> BN pairing in ``prepare`` walks; the JAX package's
``_mn_order`` stamps exist only because nnx sorts attributes by name,
and have no counterpart here.

``train_mode`` / ``eval_mode`` are ``Module.train()`` / ``Module.eval()``:
training mode updates observer and BN statistics.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from .._device import resolve_device
from ..parallel.distributed import batch_moments
from . import functional as F
from .functional import IntPair, _pair

__all__ = [
    "train_mode",
    "eval_mode",
    "Conv2d",
    "ConvTranspose2d",
    "Linear",
    "BatchNorm2d",
    "ReLU",
    "LeakyReLU",
    "Sigmoid",
    "MaxPool2d",
    "AvgPool2d",
    "AdaptiveAvgPool2d",
    "Add",
    "Concat",
    "Identity",
    "Flatten",
    "Sequential",
]

Device = Union[str, torch.device, None]


def train_mode(model: nn.Module) -> nn.Module:
    """Every submodule in training mode (statistics update)."""
    return model.train()


def eval_mode(model: nn.Module) -> nn.Module:
    """Every submodule in eval mode (statistics frozen)."""
    return model.eval()


def _uniform(shape, bound: float, dev: torch.device,
             generator: Optional[torch.Generator]) -> nn.Parameter:
    u = torch.rand(shape, generator=generator, device=dev)
    return nn.Parameter(u * (2 * bound) - bound)


class Conv2d(nn.Module):
    """2-D convolution, NCHW x OIHW, weight and bias drawn uniform in
    +-1/sqrt(fan_in) from ``generator``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
                 groups: int = 1, bias: bool = True, *, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kh, kw = _pair(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = (kh, kw)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        bound = 1.0 / math.sqrt((in_channels // groups) * kh * kw)
        self.weight = _uniform((out_channels, in_channels // groups, kh, kw), bound, dev,
                               generator)
        self.bias = _uniform((out_channels,), bound, dev, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class ConvTranspose2d(nn.Module):
    """2-D transposed convolution with torch's weight layout (in,
    out // groups, kh, kw), weight and bias drawn uniform in +-1/sqrt(fan)
    with torch's fan ``(out // groups) * kh * kw``. ``transposed_kernels``
    names the tensors of that layout for the state converters
    (``interop.py``, ``train/checkpoint.py``): the JAX package keeps them
    (kh, kw, in, out // groups)."""

    transposed_kernels = ("weight",)

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, output_padding: IntPair = 0,
                 groups: int = 1, bias: bool = True, dilation: IntPair = 1, *,
                 device: Device = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kh, kw = _pair(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = (kh, kw)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        bound = 1.0 / math.sqrt((out_channels // groups) * kh * kw)
        self.weight = _uniform((in_channels, out_channels // groups, kh, kw), bound, dev,
                               generator)
        self.bias = _uniform((out_channels,), bound, dev, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                  self.output_padding, self.dilation, self.groups)


class Linear(nn.Module):
    """Dense layer ``x @ weight (+ bias)`` with weight (in, out), both
    drawn uniform in +-1/sqrt(in) from ``generator``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device: Device = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((in_features, out_features), bound, dev, generator)
        self.bias = _uniform((out_features,), bound, dev, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class BatchNorm2d(nn.Module):
    """Batch normalization over NCHW: normalizes with the biased batch
    variance, updates ``running_var`` with the unbiased one,
    ``running = (1 - momentum) * running + momentum * batch``. Under a
    ``parallel.distributed.batch_reduction`` the batch moments are those
    of the global batch (the port's SyncBatchNorm)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1, *,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features, device=dev))  # gamma
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))  # beta
        self.register_buffer("running_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("running_var", torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var, n = batch_moments(x.to(torch.float32), (0, 2, 3))
            unbiased = var * (n / max(n - 1, 1))
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


class ReLU(nn.Module):
    """``max(x, 0)``; on int8 codes it is exact (code 0 is the value 0)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)


class Sigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size: IntPair, stride: Optional[IntPair] = None,
                 padding: IntPair = 0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size
        self.padding = _pair(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(nn.Module):
    def __init__(self, kernel_size: IntPair, stride: Optional[IntPair] = None,
                 padding: IntPair = 0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size
        self.padding = _pair(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2d(nn.Module):
    def __init__(self, output_size: IntPair):
        super().__init__()
        self.output_size = _pair(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(x, self.output_size)


class Add(nn.Module):
    """Residual add; the anchor ``prepare`` rewrites into ``QuantAdd``."""

    def forward(self, res: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        return res + shortcut


def nchw_axis(axis: int, ndim: int) -> int:
    """The dim of an NCHW tensor that the JAX package's NHWC ``axis``
    names (channels, -1 there, are dim 1 here); other ranks keep their
    axis, their layout being the same in both packages."""
    if ndim != 4:
        return axis
    return (0, 2, 3, 1)[axis % 4]


class Concat(nn.Module):
    """Concatenation of two tensors, the anchor ``prepare`` rewrites into
    ``QuantConcat``. ``axis`` is the JAX package's NHWC axis (``-1``, the
    default, is channels), so a model written from a JAX one concatenates
    the same values."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, b], dim=nchw_axis(self.axis, a.dim()))


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Flatten(nn.Module):
    """Flatten in the JAX package's NHWC order, so a Linear after it takes
    the same (in, out) weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class Sequential(nn.Module):
    """Ordered container; children live in ``layers`` and run in order."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    def __iter__(self):
        return iter(self.layers)

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        return self.layers[i]
