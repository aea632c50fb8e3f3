"""Range observers as reducers over explicit state: the counterpart of
``micronet_tpu/quant/observers.py``: min/max and EMA for QAT, the
percentile histogram and the entropy (|x| histogram) observers for PTQ.

An observer is ``(state, batch) -> state``. ``axes`` names the axes to
reduce (None = all), and the result takes the shape of the stored state:
per-tensor ``(1,)``, per-out-channel conv weights ``(O, 1, 1, 1)`` over
the port's OIHW axes (1, 2, 3), per-column linear weights ``(1, O)`` over
the (in, out) axis 0. The first batch overwrites instead of merging.

The entropy histogram counts each batch exactly (``torch.bincount``),
then adds it to the stored f32 counts. The JAX package scatter-adds 1.0
in f32, which stops counting a bin at 2^24 within one batch; the two
agree while no bin of a batch passes 2^24 values (ROADMAP.md, deliberate
differences).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .rounding import true_div

__all__ = [
    "MinMaxState",
    "init_minmax_state",
    "reduce_min_max",
    "minmax_update",
    "ema_minmax_update",
    "HistogramState",
    "init_histogram_state",
    "percentile_absmax",
    "histogram_update",
    "EntropyState",
    "init_entropy_state",
    "entropy_update",
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


# ---------------------------------------------------------------- PTQ


@dataclasses.dataclass
class HistogramState:
    """Percentile-of-|x| EMA state; ``min_val`` stays 0 (symmetric use)."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    initialized: torch.Tensor  # 0-dim bool


def init_histogram_state(stat_shape: Sequence[int] = (1,), device=None) -> HistogramState:
    s = init_minmax_state(stat_shape, device)
    return HistogramState(s.min_val, s.max_val, s.initialized)


def percentile_absmax(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """The k-th smallest of |x|, ``k = int(percentile * N)`` clipped to
    [1, N], taken as the (N - k + 1)-th largest through ``torch.topk``
    (``torch.quantile`` refuses more than 2^24 elements)."""
    flat = torch.abs(x.detach().reshape(-1)).to(torch.float32)
    n = flat.shape[0]
    k = max(min(int(percentile * n), n), 1)
    return torch.topk(flat, n - k + 1, largest=True, sorted=True).values[-1]


def histogram_update(state: HistogramState, x: torch.Tensor, percentile: float = 0.9999,
                     momentum: float = 0.1) -> HistogramState:
    """EMA of the per-batch percentile |x|; the first batch overwrites;
    ``min_val`` is left as it is."""
    cur = percentile_absmax(x, percentile).reshape(state.max_val.shape)
    ema = (1.0 - momentum) * state.max_val + momentum * cur
    init = state.initialized
    return HistogramState(state.min_val, torch.where(init, ema, cur), torch.ones_like(init))


@dataclasses.dataclass
class EntropyState:
    """|x| histogram over calibration batches: ``counts[i]`` is the mass
    in ``[i * w, (i + 1) * w)``, ``w = absmax / bins``."""

    counts: torch.Tensor  # (bins,) f32
    absmax: torch.Tensor  # 0-dim f32
    initialized: torch.Tensor  # 0-dim bool


def init_entropy_state(bins: int = 2048, device=None) -> EntropyState:
    return EntropyState(torch.zeros(bins, device=device), torch.zeros((), device=device),
                        torch.zeros((), dtype=torch.bool, device=device))


def _hist_absx(x: torch.Tensor, absmax: torch.Tensor, bins: int) -> torch.Tensor:
    """Exact counts of |x| over ``bins`` equal bins of [0, absmax] (a value
    at absmax lands in the last bin), as f32."""
    a = torch.abs(x.reshape(-1)).to(torch.float32)
    w = true_div(torch.clamp_min(absmax, torch.finfo(torch.float32).tiny), bins)
    idx = torch.clamp(torch.floor(a / w).to(torch.int64), 0, bins - 1)
    return torch.bincount(idx, minlength=bins).to(torch.float32)


def _rescale_counts(counts: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Spread a histogram over [0, m_old] onto the same bins over
    [0, m_new], ``ratio = m_old / m_new <= 1``: old bin i covers
    ``[i * ratio, (i + 1) * ratio)`` in new-bin units, at most two new
    bins, and its count splits linearly between them."""
    bins = counts.shape[0]
    i = torch.arange(bins, dtype=torch.float32, device=counts.device)
    lo = i * ratio
    hi = (i + 1.0) * ratio
    lo_bin = torch.clamp(torch.floor(lo).to(torch.int64), 0, bins - 1)
    hi_bin = torch.clamp(torch.floor(hi - 1e-12).to(torch.int64), 0, bins - 1)
    span = torch.clamp_min(hi - lo, 1e-12)
    frac_lo = torch.clamp((torch.minimum(hi, lo_bin.to(torch.float32) + 1.0) - lo) / span,
                          0.0, 1.0)
    frac_lo = torch.where(hi_bin == lo_bin, torch.ones_like(frac_lo), frac_lo)
    out = torch.zeros(bins, dtype=torch.float32, device=counts.device)
    out.index_add_(0, lo_bin, counts * frac_lo)
    out.index_add_(0, hi_bin, counts * (1.0 - frac_lo))
    return out


def entropy_update(state: EntropyState, x: torch.Tensor) -> EntropyState:
    """Add one batch to the |x| histogram; when the batch widens the range,
    the stored counts move onto the wider grid first."""
    x = x.detach()
    bins = state.counts.shape[0]
    cur_max = torch.max(torch.abs(x)).to(torch.float32)
    new_max = torch.maximum(state.absmax, cur_max)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    ratio = torch.where(new_max > 0, state.absmax / torch.clamp_min(new_max, 1e-30), one)
    old = torch.where(ratio >= 1.0 - 1e-12, state.counts, _rescale_counts(state.counts, ratio))
    return EntropyState(old + _hist_absx(x, new_max, bins), new_max,
                        torch.ones_like(state.initialized))
