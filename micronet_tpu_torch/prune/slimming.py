"""Network-slimming (BN-gamma) channel pruning, arXiv 1708.06519: the
counterpart of ``micronet_tpu/prune/slimming.py``.

- sparsity: ``s * sign(gamma)`` added to every BN weight's gradient
  between the backward and the optimizer step (:func:`bn_l1_grad_update`);
- a global threshold at the ``percent`` quantile of |gamma| over the
  first ``layers - 1`` BNs, a per-layer mask ``|gamma| > thr`` with at
  least one channel kept;
- "regular" rounding of each kept count to the nearer multiple of
  ``base_number`` (the upper one on a tie), re-thresholded at the
  ``remain``-th largest |gamma| with ``>=`` (ties keep extra channels);
- grouped-conv mode: each layer's base is the least common multiple of
  the group counts of the convs around it, from the weight shapes (masks
  and ``cfg`` only: such a net retrains from scratch at the new widths);
- model surgery: a net built at the pruned ``cfg`` widths takes the kept
  BN rows, conv output and input channels and linear input rows.

Layouts are the port's: conv kernels OIHW (out-channel axis 0, input
channels axis 1), linear weights (in, out).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..nn import modules as M
from ..nn.transform import _children

__all__ = ["bn_l1_grad_update", "compute_prune_masks", "gc_base_numbers", "prune_model",
           "sparsity_report"]


def _ordered_modules(model: nn.Module) -> List[nn.Module]:
    """Every submodule in definition order."""
    out: List[nn.Module] = []

    def rec(m: nn.Module):
        for _, child, _ in _children(m):
            out.append(child)
            rec(child)

    rec(model)
    return out


@torch.no_grad()
def bn_l1_grad_update(model: nn.Module, s: float) -> None:
    """Add ``s * sign(gamma)`` to every ``BatchNorm2d`` weight's gradient,
    in place; call it between ``backward()`` and the optimizer step."""
    for mod in model.modules():
        if isinstance(mod, M.BatchNorm2d) and mod.weight.grad is not None:
            mod.weight.grad.add_(s * torch.sign(mod.weight))


def _prunable_bns(model: nn.Module, layers: Optional[int]) -> List[M.BatchNorm2d]:
    """The first ``layers - 1`` BNs in definition order (the classifier's
    BN stays); all of them with ``layers=None``."""
    bns = [m for m in _ordered_modules(model) if isinstance(m, M.BatchNorm2d)]
    return bns if layers is None else bns[: layers - 1]


def _round_regular(remain: int, base: int, total: int) -> int:
    """Snap to the nearer multiple of ``base`` (the upper one on a tie),
    at most ``total``."""
    if base <= 1 or remain % base == 0 or remain <= base:
        return remain
    v, n = 0, 1
    while v < remain:
        n += 1
        v = base * n
    remain = v - base if remain - (v - base) < v - remain else v
    return min(remain, total)


def gc_base_numbers(model: nn.Module) -> List[int]:
    """Each BN's rounding base in a grouped-conv net: the LCM of the
    group counts of the convs before and after it (out channels of conv j
    over the input channels per group of conv j + 1)."""
    convs = [m for m in _ordered_modules(model) if isinstance(m, M.Conv2d)]
    nums = [c.weight.shape[0] for c in convs]  # out channels
    chans = [c.weight.shape[1] for c in convs]  # in channels per group
    groups = [1] + [nums[j] // chans[j + 1] for j in range(len(nums) - 1)]
    return [int(np.lcm(groups[j], groups[j + 1])) for j in range(len(groups) - 1)]


@torch.no_grad()
def compute_prune_masks(model: nn.Module, percent: float, *, base_number: int = 1,
                        gc: bool = False, layers: Optional[int] = None,
                        zero_pruned: bool = True) -> Tuple[List[int], List[np.ndarray], float]:
    """``(cfg, masks, pruned_ratio)`` from the global |gamma| threshold.
    With ``zero_pruned`` the pruned channels' gamma and beta are zeroed in
    ``model``."""
    bns = _prunable_bns(model, layers)
    if not bns:
        return [], [], 0.0
    gammas = [np.abs(bn.weight.detach().cpu().numpy()) for bn in bns]
    all_g = np.sort(np.concatenate(gammas))
    total = all_g.size
    thr = all_g[min(int(total * percent), total - 1)]
    bases = gc_base_numbers(model) if gc else None
    cfg: List[int] = []
    masks: List[np.ndarray] = []
    pruned = 0
    for i, (bn, g) in enumerate(zip(bns, gammas)):
        mask = (g > thr).astype(np.float32)
        remain = int(mask.sum())
        if remain == 0:  # keep at least one channel
            remain = 1
            mask[:] = 0.0
            mask[int(np.argmax(g))] = 1.0
        rounded = _round_regular(remain, bases[i] if gc else base_number, g.size)
        if rounded != remain:
            mask = (g >= np.sort(g)[-rounded]).astype(np.float32)
        pruned += mask.size - int(mask.sum())
        cfg.append(int(rounded))
        masks.append(mask)
        if zero_pruned:
            m = torch.from_numpy(mask).to(bn.weight.device)
            bn.weight.mul_(m)
            bn.bias.mul_(m)
    return cfg, masks, pruned / total


@torch.no_grad()
def prune_model(model: nn.Module, new_model: nn.Module, masks: Sequence[np.ndarray], *,
                layers: Optional[int] = None) -> nn.Module:
    """Copy the kept channels of ``model`` into ``new_model``, the same
    architecture built at the pruned widths. Both trees are walked in
    definition order: a pruned BN takes its kept rows; a conv takes its
    input channels by the previous mask and its outputs by the current
    one; past the prunable range a conv or linear slices its inputs only."""
    olds, news = _ordered_modules(model), _ordered_modules(new_model)
    if len(olds) != len(news):
        raise ValueError("architecture mismatch between the model and the pruned model")
    n_prunable = len(_prunable_bns(model, layers))

    def idx(mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.flatnonzero(np.asarray(mask)))

    start = torch.arange(3)  # every input image channel is kept
    mask_i = 0
    end = idx(masks[0]) if masks else None
    for m0, m1 in zip(olds, news):
        if isinstance(m0, M.BatchNorm2d):
            names = ("weight", "bias", "running_mean", "running_var")
            if mask_i < n_prunable:
                sel = idx(masks[mask_i])
                for name in names:
                    getattr(m1, name).copy_(getattr(m0, name)[sel.to(m0.weight.device)])
                mask_i += 1
                start = sel
                end = idx(masks[mask_i]) if mask_i < len(masks) else None
            else:
                for name in names:
                    getattr(m1, name).copy_(getattr(m0, name))
        elif isinstance(m0, M.Conv2d):
            dev = m0.weight.device
            w = m0.weight[:, start.to(dev)]  # OIHW: inputs on axis 1
            if mask_i < n_prunable and end is not None:
                m1.weight.copy_(w[end.to(dev)])
                if m0.bias is not None:
                    m1.bias.copy_(m0.bias[end.to(dev)])
            else:
                m1.weight.copy_(w)
                if m0.bias is not None:
                    m1.bias.copy_(m0.bias)
        elif isinstance(m0, M.Linear):
            m1.weight.copy_(m0.weight[start.to(m0.weight.device)])
            if m0.bias is not None:
                m1.bias.copy_(m0.bias)
    return new_model


def sparsity_report(model: nn.Module) -> dict:
    """Per-BN |gamma| statistics of a sparsity-trained model."""
    out = {}
    bns = [m for m in _ordered_modules(model) if isinstance(m, M.BatchNorm2d)]
    for i, bn in enumerate(bns):
        g = np.abs(bn.weight.detach().cpu().numpy())
        out[f"bn{i}"] = {"channels": int(g.size), "mean_abs_gamma": float(g.mean()),
                         "frac_below_1e-2": float((g < 1e-2).mean())}
    return out
