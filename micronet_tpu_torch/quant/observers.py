"""Range observers as reducers over explicit state: the counterpart of
``micronet_tpu/quant/observers.py`` (min/max and EMA; the histogram and
entropy observers of PTQ/KL calibration are not ported yet).

An observer is ``(state, batch) -> state``. ``axes`` names the axes to
reduce (None = all), and the result takes the shape of the stored state:
per-tensor ``(1,)``, per-out-channel conv weights ``(O, 1, 1, 1)`` over
the port's OIHW axes (1, 2, 3), per-column linear weights ``(1, O)`` over
the (in, out) axis 0. The first batch overwrites instead of merging.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "MinMaxState",
    "init_minmax_state",
    "reduce_min_max",
    "minmax_update",
    "ema_minmax_update",
]


@dataclasses.dataclass
class MinMaxState:
    """Running min/max statistics and the first-batch flag."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    initialized: torch.Tensor  # 0-dim bool


def init_minmax_state(stat_shape: Sequence[int] = (1,), device=None) -> MinMaxState:
    shape = tuple(stat_shape)
    return MinMaxState(torch.zeros(shape, device=device), torch.zeros(shape, device=device),
                       torch.zeros((), dtype=torch.bool, device=device))


def reduce_min_max(x: torch.Tensor, axes: Optional[Sequence[int]] = None,
                   stat_shape: Sequence[int] = (1,)) -> Tuple[torch.Tensor, torch.Tensor]:
    """This batch's min and max over ``axes``, shaped as ``stat_shape``."""
    x = x.detach().to(torch.float32)
    if axes is None:
        cur_min, cur_max = torch.min(x), torch.max(x)
    else:
        cur_min = torch.amin(x, dim=tuple(axes), keepdim=True)
        cur_max = torch.amax(x, dim=tuple(axes), keepdim=True)
    return cur_min.reshape(tuple(stat_shape)), cur_max.reshape(tuple(stat_shape))


def minmax_update(state: MinMaxState, x: torch.Tensor,
                  axes: Optional[Sequence[int]] = None) -> MinMaxState:
    """Cumulative min/max; the first batch overwrites."""
    cur_min, cur_max = reduce_min_max(x, axes, state.min_val.shape)
    init = state.initialized
    return MinMaxState(
        torch.where(init, torch.minimum(cur_min, state.min_val), cur_min),
        torch.where(init, torch.maximum(cur_max, state.max_val), cur_max),
        torch.ones_like(init),
    )


def ema_minmax_update(state: MinMaxState, x: torch.Tensor,
                      axes: Optional[Sequence[int]] = None,
                      momentum: float = 0.1) -> MinMaxState:
    """``(1 - m) * stored + m * current``; the first batch overwrites."""
    cur_min, cur_max = reduce_min_max(x, axes, state.min_val.shape)
    ema_min = (1.0 - momentum) * state.min_val + momentum * cur_min
    ema_max = (1.0 - momentum) * state.max_val + momentum * cur_max
    init = state.initialized
    return MinMaxState(torch.where(init, ema_min, cur_min),
                       torch.where(init, ema_max, cur_max), torch.ones_like(init))
