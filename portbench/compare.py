"""The numbers that decide ``correct``, each taken from the program's
outputs beside the plain reference's.

Engine cells (answers checked one by one): every timed call's logits
against the reference's logits of the same images, relative to
``max(1, max |reference logit|)`` over the cell's input pool:

- ``logit_gap``: the largest |program - reference| of any logit;
- ``top1_regret``: the largest amount by which the reference's logit of
  the program's top class lies below the reference's best, in a row;
- ``logit_mean_gap``: the mean |program - reference| over every logit of
  every call. A sound engine moves a code only where a value sits on a
  rounding edge, so its gaps are few and sparse; an engine a bit narrower,
  or with its epilogue rounded to bfloat16, moves codes everywhere.

Training cells (the first steps of the timed object, read from set-up):

- ``loss1_gap``: |program - reference| / |reference| of the first step's
  loss (each step's is recorded beside it as ``loss_gaps``);
- ``grad_gap``: the first gradient's norm, leaf by leaf (the program's
  taken from Adam's first moment after one step), worst leaf;
- ``step_gap``: the norm of each leaf's change over the steps, worst leaf.

A leaf's gap is ``| |p| - |r| | / max(|r|, median leaf |r|)``. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both (a conv bias under a batch-statistics BN has a gradient of
zero up to rounding, and Adam moves it by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

NEGLIGIBLE = 1e-3


def engine_numbers(outputs: Sequence[Tuple[int, torch.Tensor]],
                   reference: Sequence[torch.Tensor]):
    """``outputs`` are ``(pool index, logits)`` of every call, ``reference``
    the reference's logits of each pool batch. Returns the numbers over
    all calls and each call's own ``logit_gap`` and ``top1_regret``."""
    scale = max(1.0, max(float(r.abs().max()) for r in reference))
    per_call, total, count = [], 0.0, 0
    for idx, y in outputs:
        ref = reference[idx].to(y.device, torch.float32)
        y = y.to(torch.float32)
        if not bool(torch.isfinite(y).all()):
            per_call.append({"logit_gap": float("inf"), "top1_regret": float("inf")})
            continue
        picked = ref.gather(1, y.argmax(1, keepdim=True)).squeeze(1)
        diff = (y - ref).abs()
        total, count = total + float(diff.double().sum()) / scale, count + diff.numel()
        per_call.append({"logit_gap": float(diff.max()) / scale,
                         "top1_regret": float((ref.max(1).values - picked).max()) / scale})
    numbers = {k: max(c[k] for c in per_call) for k in ("logit_gap", "top1_regret")}
    finite = all(c["logit_gap"] < float("inf") for c in per_call)
    numbers["logit_mean_gap"] = total / count if finite else float("inf")
    return numbers, per_call


def failed_calls(per_call: Sequence[Dict[str, float]], limits: Dict[str, float]) -> int:
    """Calls whose own numbers break a limit."""
    return sum(1 for c in per_call if any(not (v <= limits[k]) for k, v in c.items()
                                          if k in limits))


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm (f64)."""
    return {k: float(v.detach().to(torch.float64).norm()) for k, v in leaves.items()}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap and its name."""
    floor = statistics.median(reference[k] for k in keep)
    return max((abs(program[k] - reference[k]) / max(reference[k], floor), k) for k in keep)


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= NEGLIGIBLE * median)


def train_numbers(program: dict, reference: dict) -> dict:
    """``program`` and ``reference`` hold ``losses`` (floats), ``grad`` and
    ``delta`` (leaf norms, or tensors for the reference)."""
    ref_grad = reference["grad"] if isinstance(next(iter(reference["grad"].values())), float) \
        else norms(reference["grad"])
    ref_delta = reference["delta"] if isinstance(next(iter(reference["delta"].values())), float) \
        else norms(reference["delta"])
    keep = kept_leaves(ref_grad)
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]) or not losses:
        losses = [float("inf")]
    grad_gap, grad_leaf = leaf_gap(program["grad"], ref_grad, keep)
    step_gap, step_leaf = leaf_gap(program["delta"], ref_delta, keep)
    return {"loss1_gap": losses[0], "grad_gap": grad_gap, "step_gap": step_gap,
            "loss_gaps": losses, "grad_worst_leaf": grad_leaf, "step_worst_leaf": step_leaf}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """``(name, value, limit)`` of every number that has a limit."""
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]
