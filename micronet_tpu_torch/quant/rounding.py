"""Rounding and straight-through estimators: the counterpart of
``micronet_tpu/quant/rounding.py``.

Rounding is half away from zero, ``sign(x) * floor(|x| + 0.5)``, never
``torch.round`` (which rounds half to even and so moves codes that sit on
a .5 boundary).

The wbwtab signs map 0 (and -0.0) to +1: ``where(x >= 0, 1, -1)``, which
is not ``torch.sign``. Plain STEs are written ``(x - x.detach()) + f(x)``:
``x - x`` is exactly 0, so the forward value is bit for bit ``f(x)``.
"""

from __future__ import annotations

import torch

__all__ = ["round_half_away", "ste_round", "clip_ste_round", "binary_act", "binary_weight",
           "ternary"]


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


def _sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """+1 where ``x >= 0`` (0 and -0.0 included), else -1 (NaN too): one
    compare and one select over ``x``."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


class _BinaryAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward((x > -1.0) & (x < 1.0))
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g))


def binary_act(x: torch.Tensor) -> torch.Tensor:
    """Binary activation: +1 where ``x >= 0``, else -1. The saturate-STE
    passes the gradient only where ``-1 < x < 1``, strictly; its mask is
    formed only when a gradient is recorded."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _BinaryAct.apply(x)
    return _sign_pm1(x)


def binary_weight(x: torch.Tensor) -> torch.Tensor:
    """Binary weight, +1 where ``x >= 0``, else -1; identity gradient."""
    return (x - x.detach()) + _sign_pm1(x.detach())


def ternary(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """``sign(sign(x + thr) + sign(x - thr))`` in {-1, 0, +1}; identity
    gradient to ``x``, none to ``threshold``."""
    xd, thr = x.detach(), threshold.detach()
    y = torch.sign(torch.sign(xd + thr) + torch.sign(xd - thr))
    return (x - xd) + y
