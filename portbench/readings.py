"""What several per-layer readers share: the traced stretch of a cell of
one kind, and the arithmetic of shares."""

from __future__ import annotations

from typing import Callable, Optional

from . import work


def stretch_of(run, kind: str, multi: Optional[bool] = None):
    """The traced stretch when this run is of ``kind`` (``infer`` or
    ``train``; for training, ``multi`` picks several ranks or one) and the
    card ran kernels in it, else None."""
    w = run.window
    if run.stretch is None or not run.stretch["kernels"] or w.get("kind") != kind:
        return None
    if multi is not None and (w["ranks"] > 1) != multi:
        return None
    return run.stretch


def idle_pct(stretch, busy_key: str = "busy_s") -> float:
    """The share of the traced window in which no operation ran on the card."""
    return 100.0 * (1.0 - stretch[busy_key] / stretch["window_s"])


def kernel_seconds(stretch, keep: Callable[[str], bool]) -> float:
    return sum(s for name, s in stretch["kernels"] if keep(name))


def per_step(stretch, value: float) -> float:
    return value / stretch["steps"]


def mfu_pct(run, flops_per_image: float, peak: float, cards: int = 1) -> float:
    """The window's operations (counted from the layer shapes) over its
    time, as a share of ``cards`` x the published ``peak``."""
    w = run.window
    return 100.0 * flops_per_image * w["images"] / w["seconds"] / (peak * cards)


def flops_per_image(run) -> float:
    """Operations an image takes in this run's cell: the forward's for an
    engine, a training step's (3 x the forward) for a trainer."""
    ops = work.arch_ops(run.config)
    if run.window.get("kind") == "train":
        return float(work.train_flops_per_image(ops))
    return 2.0 * work.forward_macs(ops)
