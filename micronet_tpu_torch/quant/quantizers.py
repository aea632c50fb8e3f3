"""IAO fake-quant core: the counterpart of
``micronet_tpu/quant/quantizers.py``.

Range table:

=============  ========  =======================  ====================
quantizer      tensor    qmin                     qmax
=============  ========  =======================  ====================
signed         weight    -(2^(b-1) - 1)           2^(b-1) - 1
signed         act       -2^(b-1)                 2^(b-1) - 1
unsigned       weight    0                        2^b - 2
unsigned       act       0                        2^b - 1
=============  ========  =======================  ====================

Symmetric quantization is signed, asymmetric unsigned. Every function
does the JAX package's f32 operations in its order, so codes and scales
agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .rounding import clip, round_half_away, true_div

__all__ = [
    "FLOAT32_EPS",
    "quant_range",
    "symmetric_qparams",
    "asymmetric_qparams",
    "fake_quant_codes",
    "fake_quant",
    "quantize_int",
    "dequantize_int",
]

# the scale floor: float32 machine epsilon
FLOAT32_EPS = float(np.finfo(np.float32).eps)


def quant_range(bits: int, symmetric: bool, is_weight: bool) -> Tuple[float, float]:
    """(qmin, qmax) of the range table above."""
    if symmetric:
        if is_weight:
            return (-float((1 << (bits - 1)) - 1), float((1 << (bits - 1)) - 1))
        return (-float(1 << (bits - 1)), float((1 << (bits - 1)) - 1))
    if is_weight:
        return (0.0, float((1 << bits) - 2))
    return (0.0, float((1 << bits) - 1))


def symmetric_qparams(min_val, max_val, qmin: float, qmax: float,
                      eps: float = FLOAT32_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scale = max(|min|, |max|) / ((qmax - qmin) / 2)`` floored at eps;
    ``zero_point = 0``."""
    float_range = torch.maximum(torch.abs(min_val), torch.abs(max_val))
    scale = torch.clamp_min(true_div(float_range, (qmax - qmin) / 2.0), eps)
    return scale, torch.zeros_like(scale)


def asymmetric_qparams(min_val, max_val, qmin: float, qmax: float,
                       eps: float = FLOAT32_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scale = (max - min) / (qmax - qmin)`` floored at eps;
    ``zero_point = sign(min) * floor(|min / scale| + 0.5)``."""
    scale = torch.clamp_min(true_div(max_val - min_val, qmax - qmin), eps)
    zero_point = torch.sign(min_val) * torch.floor(torch.abs(min_val / scale) + 0.5)
    return scale, zero_point


def fake_quant_codes(x, scale, zero_point, qmin: float, qmax: float,
                     obs_min, obs_max, symmetric: bool) -> torch.Tensor:
    """The integer codes ``clamp(round(x/s - zp), qmin, qmax)`` as f32,
    such that ``fake_quant(x, ...) == (codes + zp) * s`` bit for bit. The
    gradient with respect to ``x`` is the clip-STE one over ``1/s``: it
    passes inside the observer range and is halved on its bounds, as
    ``jnp.clip`` gives it, carried by ``clip(v, lo, hi)`` under the exact
    ``(base - base.detach())`` form."""
    x = x.to(torch.float32)
    scale = scale.detach()
    zero_point = zero_point.detach()
    lo = (obs_min / scale - zero_point).detach()
    hi = (obs_max / scale - zero_point).detach()
    if symmetric:
        bound = torch.maximum(torch.abs(lo), torch.abs(hi))
        lo, hi = -bound, bound
    v = x / scale - zero_point
    base = clip(v, lo, hi)
    q_val = torch.clamp(round_half_away(v.detach()), qmin, qmax)
    return (base - base.detach()) + q_val


def fake_quant(x, scale, zero_point, qmin: float, qmax: float,
               obs_min, obs_max, symmetric: bool) -> torch.Tensor:
    """``(clamp(clip_ste_round(x / s - zp), qmin, qmax) + zp) * s``."""
    q = fake_quant_codes(x, scale, zero_point, qmin, qmax, obs_min, obs_max, symmetric)
    return ((q + zero_point.detach()) * scale.detach()).to(x.dtype)


def quantize_int(x, scale, zero_point, qmin: float, qmax: float,
                 dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """``clamp(round_half_away(x / s - zp), qmin, qmax)`` as integers."""
    q = round_half_away(x / scale - zero_point)
    return torch.clamp(q, qmin, qmax).to(dtype)


def dequantize_int(q, scale, zero_point) -> torch.Tensor:
    """Inverse of :func:`quantize_int`: ``(q + zp) * s``."""
    return (q.to(torch.float32) + zero_point) * scale
