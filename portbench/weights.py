"""Inputs made from the seed, on the device, in a few large calls: the
weights of a network (one uniform draw for every leaf), Gaussian images
and a uint8 training set. The same seed gives the same inputs, and both
the program and the reference are handed them."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference import arch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any integer: folded into
    the 64 bits a generator takes)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def make_weights(ops: List[dict], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every parameter and BN buffer of ``ops`` in float32: weights and
    biases uniform in +-1/sqrt(fan_in) (PyTorch's default conv and linear
    init), BN gamma uniform in [0.5, 1.5] and beta in +-0.1, running
    statistics at their initial 0 and 1."""
    spec = arch.param_shapes(ops)
    total = sum(math.prod(shape) for shape, _, _ in spec.values())
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for key, (shape, role, fan_in) in spec.items():
        n = math.prod(shape)
        v = u[off:off + n].view(shape)
        off += n
        if role in ("weight", "bias"):
            bound = 1.0 / math.sqrt(fan_in)
            out[key] = v * (2 * bound) - bound
        elif role == "gamma":
            out[key] = v + 0.5
        elif role == "beta":
            out[key] = v * 0.2 - 0.1
        elif role == "mean":
            out[key] = torch.zeros(shape, device=device)
        else:
            out[key] = torch.ones(shape, device=device)
    return out


def gaussian_images(gen: torch.Generator, device, *lead: int) -> torch.Tensor:
    """Standard normal NHWC images of shape ``(*lead, 32, 32, 3)``."""
    return torch.randn((*lead, 32, 32, 3), generator=gen, device=device)


def uint8_set(gen: torch.Generator, device, n: int, classes: int = 10):
    """A CIFAR-10-shaped stand-in: ``n`` uniform uint8 NHWC images and labels."""
    images = torch.randint(0, 256, (n, 32, 32, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    return images, labels
