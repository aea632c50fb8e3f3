"""Entropy (KL-divergence) calibration, the int8 build-time pass: the
counterpart of ``micronet_tpu/quant/calibrate.py``.

1. Calibration batches stream through a PTQ-prepared model whose
   activation quantizers carry an |x| histogram
   (``QuantConfig(ptq=True, ptq_observer="kl")``).
2. :func:`finalize_entropy_calibration` runs the KL threshold search once
   per tensor on the host and writes each threshold into its quantizer's
   ``max_val``, so the ordinary qparams take over.
3. ``cache=`` is a calibration table file: read when no statistics were
   streamed, written (or refreshed) otherwise.

A quantizer's table key is its module path joined with ``/``
(``features/layers/0/activation_quantizer``), the JAX package's key, so
either package reads the other's table.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "kl_threshold",
    "finalize_entropy_calibration",
    "load_calibration_cache",
    "save_calibration_cache",
]


def _smooth_distribution(p: np.ndarray, eps: float = 1e-4):
    """Move ``eps`` of probability onto each zero entry, taken pro rata
    from the nonzero ones, so that KL(P || Q) stays finite."""
    is_zero = p == 0
    n_zero = int(is_zero.sum())
    n_nonzero = p.size - n_zero
    if n_nonzero == 0:
        return None
    if n_zero == 0:
        return p
    eps1 = eps * n_zero / n_nonzero
    if (p[~is_zero] <= eps1).any():
        return None
    out = p.copy()
    out[is_zero] = eps
    out[~is_zero] -= eps1
    return out


def kl_threshold(counts: np.ndarray, absmax: float, num_quantized_bins: int = 128) -> float:
    """The |x| clip threshold that minimizes KL(P || Q), entropy
    calibration's search: for each number ``i`` of kept bins, P folds the
    tail into bin ``i - 1`` and Q quantizes the kept bins to
    ``num_quantized_bins`` levels spread back over P's nonzero support.
    Returns the right edge of the best ``i``. numpy, in f64."""
    counts = np.asarray(counts, np.float64)
    bins = counts.shape[0]
    absmax = float(absmax)
    total = counts.sum()
    if absmax <= 0.0 or total <= 0.0 or bins <= num_quantized_bins:
        return absmax
    width = absmax / bins
    nonzero = counts > 0
    best_i, best_kl = bins, np.inf
    for i in range(num_quantized_bins, bins + 1):
        p = counts[:i].copy()
        p[i - 1] += counts[i:].sum()
        nz = nonzero[:i]
        idx = np.arange(i) * num_quantized_bins // i
        group_mass = np.bincount(idx, weights=counts[:i], minlength=num_quantized_bins)
        group_support = np.bincount(idx, weights=nz.astype(np.float64),
                                    minlength=num_quantized_bins)
        expand = np.divide(group_mass, group_support, out=np.zeros_like(group_mass),
                           where=group_support > 0)
        q = expand[idx] * nz
        if q.sum() <= 0:
            continue
        # both smoothed, so clipped mass where Q has no support costs KL
        p = _smooth_distribution(p / p.sum())
        q = _smooth_distribution(q / q.sum())
        if p is None or q is None:
            continue
        kl = np.sum(p * np.log(p / q))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return min((best_i + 0.5) * width, absmax)


def _entropy_quantizers(model: nn.Module):
    from ..nn.qat_iao import FakeQuantizer

    for name, mod in model.named_modules():
        if isinstance(mod, FakeQuantizer) and mod.observer == "entropy" and not mod.union:
            yield name.replace(".", "/"), mod


def load_calibration_cache(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def save_calibration_cache(path: str, table: Dict[str, float]) -> None:
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)


@torch.no_grad()
def finalize_entropy_calibration(model: nn.Module, cache: Optional[str] = None,
                                 num_quantized_bins: int = 128) -> Dict[str, float]:
    """Resolve every entropy quantizer's threshold and refresh its
    scale/zero_point; returns the table ``{module path: threshold}``.

    An existing ``cache`` file stands in for the search only when no
    quantizer streamed statistics (a fresh build); live histograms win
    and rewrite the file, so calibration over more epochs keeps
    improving."""
    quantizers = list(_entropy_quantizers(model))
    cached = None
    if cache and os.path.exists(cache):
        cached = load_calibration_cache(cache)
    if cached is not None and any(bool(fq.initialized) for _, fq in quantizers):
        cached = None
    if cached is not None:
        missing = [path for path, _ in quantizers if path not in cached]
        if missing:
            raise KeyError(f"calibration cache {cache!r} has no entry for {missing[0]!r}")
        thresholds = [cached[path] for path, _ in quantizers]
    else:
        counts = (np.stack([fq.ent_counts.cpu().numpy().astype(np.float64)
                            for _, fq in quantizers]) if quantizers else np.zeros((0, 1)))
        absmax = np.asarray([float(fq.ent_absmax) for _, fq in quantizers], np.float64)
        # the O(bins^2) search per tensor runs in the native host library
        # when it is built (parallel over tensors), in numpy otherwise;
        # both give the same thresholds
        from ..train.native_loader import kl_thresholds_batch

        native = (kl_thresholds_batch(counts, absmax, num_quantized_bins)
                  if quantizers else None)
        if native is not None:
            thresholds = [float(t) for t in native]
        else:
            thresholds = [kl_threshold(counts[i], absmax[i], num_quantized_bins)
                          for i in range(len(quantizers))]
    table: Dict[str, float] = {}
    for (path, fq), thr in zip(quantizers, thresholds):
        table[path] = float(thr)
        # symmetric qparams take max(|min|, |max|): min stays 0
        fq.max_val.fill_(thr)
        fq.initialized.fill_(True)
        fq.update_qparams()
    _refresh_union_scales(model)
    if cache and cached is None:
        save_calibration_cache(cache, table)
    return table


@torch.no_grad()
def _refresh_union_scales(model: nn.Module) -> None:
    """Set each ``QuantAdd``'s and ``QuantConcat``'s shared quantizer to
    the union of its two (now resolved) entropy observers: while the
    histograms streamed, the union written in the forward was
    meaningless."""
    from ..nn.qat_iao import QuantAdd, QuantConcat

    for mod in model.modules():
        if not isinstance(mod, (QuantAdd, QuantConcat)):
            continue
        sides = mod.sides()
        if any(s.observer != "entropy" for s in sides):
            continue
        uq = mod.activation_quantizer
        uq.min_val.copy_(torch.minimum(sides[0].min_val, sides[1].min_val))
        uq.max_val.copy_(torch.maximum(sides[0].max_val, sides[1].max_val))
        uq.initialized.fill_(True)
        uq.update_qparams()
