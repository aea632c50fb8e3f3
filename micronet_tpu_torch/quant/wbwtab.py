"""wbwtab: ternary/binary weights and binary activations, the counterpart
of ``micronet_tpu/quant/wbwtab.py``.

``W == 2``: binary weights {-1, +1} times a per-out-channel alpha =
E(|w|) of the mean-centred, clamped weight; ``W == 3``: ternary weights
{-1, 0, +1} with the threshold 0.7 * E(|w|) and alpha the mean of the
|w| above it; ``A == 2``: binary activations with the saturate-STE;
32 = float.

Axes: the JAX package keeps conv weights HWIO and reduces over (0, 1, 2),
with the input-channel mean over axis 2. The port keeps them OIHW, so
the per-out-channel reductions run over (1, 2, 3) and the input-channel
mean over axis 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .rounding import binary_act, binary_weight, clip, ternary

__all__ = ["mean_center_clamp", "quantize_weight", "quantize_activation"]

# OIHW: reduce over input channels and space, keep the out channel
_CHANNEL_AXES = (1, 2, 3)
_INPUT_CHANNEL_AXIS = 1


def mean_center_clamp(w: torch.Tensor) -> torch.Tensor:
    """Subtract each (out, h, w) filter's mean over input channels, then
    clamp to [-1, 1]."""
    mean = torch.mean(w, dim=_INPUT_CHANNEL_AXIS, keepdim=True)
    return clip(w - mean, -1.0, 1.0)


def _binary_quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """W == 2: centre and clamp, alpha = E(|w|) per out channel, output
    sign(w) * alpha. Returns (quantized, centred)."""
    centered = mean_center_clamp(w)
    alpha = torch.mean(torch.abs(centered), dim=_CHANNEL_AXES, keepdim=True).detach()
    return binary_weight(centered) * alpha, centered


def _ternary_quantize(w: torch.Tensor) -> torch.Tensor:
    """W == 3: threshold 0.7 * E(|w|) per out channel; alpha = the sum of
    the |w| above it over their count. A channel with no |w| above its
    threshold (all zeros) gets a NaN alpha, as in the reference."""
    w_abs = torch.abs(w.detach())
    threshold = 0.7 * torch.mean(w_abs, dim=_CHANNEL_AXES, keepdim=True)
    t = ternary(w, threshold)
    above = w_abs > threshold
    kept_sum = torch.sum(torch.where(above, w_abs, torch.zeros_like(w_abs)),
                         dim=_CHANNEL_AXES, keepdim=True)
    kept_cnt = torch.sum(above.to(torch.float32), dim=_CHANNEL_AXES, keepdim=True)
    return t * (kept_sum / kept_cnt)


def quantize_weight(w: torch.Tensor, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(quantized, new_master)``: ``new_master`` is the value the
    reference leaves in the parameter after its in-place preprocessing
    (centred and clamped for W == 2, unchanged otherwise)."""
    if W == 2:
        return _binary_quantize(w)
    if W == 3:
        return _ternary_quantize(w), w
    return w, w


def quantize_activation(x: torch.Tensor, A: int) -> torch.Tensor:
    """A == 2: binary sign with the saturate-STE. Otherwise ReLU: the
    quantizer takes a ReLU's place in the rewritten net."""
    if A == 2:
        return binary_act(x)
    return torch.relu(x)
