"""Human-readable model and parameter dumps: the counterpart of
``micronet_tpu/infer/dump.py``, keyed and laid out as the checkpoints are
(``train/checkpoint.py``: the JAX package's keys, HWIO conv kernels).

- ``dump_model_txt(path, model)``: the module tree with each module's
  tensors (shape, dtype) and plain attributes, then every array in full.
- ``dump_params_json(path, model)``: every array's shape and dtype, with
  the small quantization tensors (scales, zero points, alpha) inlined.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
from torch import nn

from ..train.checkpoint import state_to_arrays

__all__ = ["dump_model_txt", "dump_params_json"]

_QUANT_KEYS = ("scale", "zero_point", "act_scale", "w_scale", "alpha", "out_scale")


def _module_tree_lines(model: nn.Module) -> list:
    lines = []
    for name, mod in model.named_modules():
        attrs = []
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for k, v in tensors:
            if v is not None:
                attrs.append(f"{k}{list(v.shape)}:{str(v.dtype).replace('torch.', '')}")
        for k, v in vars(mod).items():
            if isinstance(v, (int, float, bool, str, tuple)) and not k.startswith("_"):
                attrs.append(f"{k}={v}")
        lines.append(f"{name.replace('.', '/') or '<root>'}: "
                     f"{type(mod).__name__}({', '.join(attrs)})")
    return lines


def dump_model_txt(path: str, model: nn.Module) -> None:
    """Write the module tree and every parameter's values as text."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = state_to_arrays(model)
    with open(path, "w") as f:
        f.write("# module tree\n")
        for line in _module_tree_lines(model):
            f.write(line + "\n")
        f.write("\n# parameters\n")
        for key in sorted(arrays):
            arr = arrays[key]
            f.write(f"\n{key}  shape={list(arr.shape)}  dtype={arr.dtype}\n")
            f.write(np.array2string(arr, threshold=np.inf, max_line_width=120, precision=6)
                    + "\n")


def dump_params_json(path: str, model: nn.Module) -> None:
    """Every array's shape and dtype; scales, zero points and alphas of up
    to 4,096 values inlined."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out: Dict[str, Any] = {}
    arrays = state_to_arrays(model)
    for key in sorted(arrays):
        arr = arrays[key]
        entry: Dict[str, Any] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        if arr.size <= 4096 and any(q in key.rsplit("/", 2) for q in _QUANT_KEYS):
            entry["values"] = np.asarray(arr, dtype=np.float64).reshape(-1).tolist()
        out[key] = entry
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
