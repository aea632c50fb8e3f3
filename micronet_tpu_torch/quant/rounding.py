"""Rounding and straight-through estimators: the counterpart of
``micronet_tpu/quant/rounding.py`` (the IAO and DoReFa parts).

Rounding is half away from zero, ``sign(x) * floor(|x| + 0.5)``, never
``torch.round`` (which rounds half to even and so moves codes that sit on
a .5 boundary).
"""

from __future__ import annotations

import torch

__all__ = ["round_half_away", "ste_round", "clip_ste_round"]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``sign(x) * floor(|x| + 0.5)``: round_half_away(0.5) == 1,
    round_half_away(-1.5) == -2."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half away with an identity gradient. ``(x - x.detach())`` is
    exactly 0, so the forward value is bit for bit the rounded one."""
    return (x - x.detach()) + round_half_away(x.detach())


class _ClipSteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward((x >= lo) & (x <= hi))
        return round_half_away(x)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None, None


def clip_ste_round(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Round half away; the gradient passes where ``lo <= x <= hi`` (the
    bounds themselves included) and is zero outside. ``lo``/``hi`` are
    observer bounds in quantized units and receive no gradient."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return _ClipSteRound.apply(x, lo, hi)
