"""Checkpoints: the counterpart of ``micronet_tpu/train/checkpoint.py``, in
its file format, so that either package's ``load_state`` reads the other's
model state.

A checkpoint is one ``np.savez`` archive: ``model/<key>`` for every
parameter and buffer, ``opt/<key>`` for the optimizer state and a JSON
``__header__`` ``{"step", "best_acc", "extra"}`` (``extra`` holds e.g. a
pruned model's ``cfg``). Model keys and layouts are the JAX package's:
the nnx state path joined with ``/`` and ending in ``/.value``
(``model/layers/0/conv/weight/.value``), conv kernels HWIO and
per-channel conv statistics (1, 1, 1, O), transposed-conv kernels (kh,
kw, in, out // groups): every 4-D tensor moves through the inverse of
``interop.cnn_state_from_numpy``'s transpose, chosen by its module. The
optimizer state is the port's own (``optim.Adam``'s ``mu``, ``nu`` and
``count`` per parameter key); a reader that does not know a key keeps its
own state for it, in both packages.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..interop import (HWIO_TO_OIHW, KKIO_TO_IOKK, OIHW_TO_HWIO,
                       transposed_kernel_keys)

__all__ = ["save_state", "save_state_async", "wait_for_saves", "load_state",
           "state_to_arrays", "arrays_to_state", "jax_key", "port_key"]

_SUFFIX = "/.value"
_OPT_FIELDS = ("mu", "nu", "count")


def jax_key(key: str) -> str:
    """``state_dict`` key -> the JAX package's flat state key."""
    return key.replace(".", "/") + _SUFFIX


def port_key(key: str) -> str:
    """The JAX package's flat state key -> ``state_dict`` key."""
    if key.endswith(_SUFFIX):
        key = key[: -len(_SUFFIX)]
    return key.replace("/", ".")


def _to_jax_layout(t: torch.Tensor, transposed: bool) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    if arr.ndim != 4:
        return arr
    return np.ascontiguousarray(arr.transpose(KKIO_TO_IOKK if transposed else OIHW_TO_HWIO))


def _from_jax_layout(arr: np.ndarray, transposed: bool) -> np.ndarray:
    if arr.ndim != 4:
        return arr
    return np.ascontiguousarray(arr.transpose(KKIO_TO_IOKK if transposed else HWIO_TO_OIHW))


def state_to_arrays(model: nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter and buffer as a flat ``{JAX key: array}`` dict in
    the JAX package's layouts."""
    transposed = transposed_kernel_keys(model)
    return {jax_key(k): _to_jax_layout(v, k in transposed)
            for k, v in model.state_dict().items()}


@torch.no_grad()
def arrays_to_state(model: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Load flat arrays (keys with or without ``/.value``) into ``model``
    in place; every key of the model must be there, with its shape."""
    by_key = {port_key(k): v for k, v in arrays.items()}
    transposed = transposed_kernel_keys(model)
    for key, t in model.state_dict().items():
        if key not in by_key:
            raise KeyError(f"checkpoint missing {jax_key(key)}")
        arr = _from_jax_layout(np.asarray(by_key[key]), key in transposed)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {jax_key(key)}: ckpt {arr.shape} vs model "
                             f"{tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))


def _param_keys(model: nn.Module) -> Dict[int, str]:
    return {id(p): k.replace(".", "/") for k, p in model.named_parameters()}


def _snapshot_arrays(model: nn.Module, optimizer: Optional[torch.optim.Optimizer], step: int,
                     best_acc: float, extra: Optional[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Device -> host snapshot plus the header, shared by both writers."""
    arrays = {f"model/{k}": v for k, v in state_to_arrays(model).items()}
    if optimizer is not None:
        names = _param_keys(model)
        for group in optimizer.param_groups:
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                for field in _OPT_FIELDS:
                    if field in st:
                        v = torch.as_tensor(st[field])
                        arrays[f"opt/{names[id(p)]}/{field}"] = v.detach().cpu().numpy()
    header = json.dumps({"step": step, "best_acc": best_acc, "extra": extra or {}})
    arrays["__header__"] = np.frombuffer(header.encode(), dtype=np.uint8)
    return arrays


def _write_atomic(path: str, arrays: Dict[str, np.ndarray], tag: str = "") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{tag}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_state(path: str, model: nn.Module, *, optimizer=None, step: int = 0,
               best_acc: float = 0.0, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint (atomically: a temporary file, then a rename)."""
    _write_atomic(path, _snapshot_arrays(model, optimizer, step, best_acc, extra))


_PENDING_SAVES: list = []  # (thread, errors)
_SAVE_SEQ = [0]


def save_state_async(path: str, model: nn.Module, *, optimizer=None, step: int = 0,
                     best_acc: float = 0.0, extra: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot now, write on a background thread. Each writer has its own
    temporary file and waits for the one before it, so saves land in
    order; errors come out of :func:`wait_for_saves`."""
    arrays = _snapshot_arrays(model, optimizer, step, best_acc, extra)
    prev = _PENDING_SAVES[-1][0] if _PENDING_SAVES else None
    _SAVE_SEQ[0] += 1
    tag = f".{_SAVE_SEQ[0]}"
    errors: list = []

    def write():
        try:
            if prev is not None:
                prev.join()
            _write_atomic(path, arrays, tag)
        except Exception as e:  # re-raised by wait_for_saves
            errors.append(e)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    _PENDING_SAVES.append((t, errors))


def wait_for_saves() -> None:
    """Join every pending asynchronous save; raise if any failed."""
    errors = []
    while _PENDING_SAVES:
        t, errs = _PENDING_SAVES.pop()
        t.join()
        errors.extend(errs)
    if errors:
        raise RuntimeError(f"async checkpoint write(s) failed: {errors}")


@torch.no_grad()
def load_state(path: str, model: nn.Module, *,
               optimizer=None) -> Tuple[int, float, Dict[str, Any]]:
    """Restore ``model`` (and the optimizer's moments, where the file has
    them) in place; returns ``(step, best_acc, extra)``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays.pop("__header__")).decode())
    arrays_to_state(model, {k[len("model/"):]: v for k, v in arrays.items()
                            if k.startswith("model/")})
    if optimizer is not None:
        names = _param_keys(model)
        for group in optimizer.param_groups:
            for p in group["params"]:
                fields = {f: arrays.get(f"opt/{names[id(p)]}/{f}") for f in _OPT_FIELDS}
                if any(v is None for v in fields.values()):
                    continue
                optimizer.state[p] = {
                    "mu": torch.from_numpy(fields["mu"]).to(p.device),
                    "nu": torch.from_numpy(fields["nu"]).to(p.device),
                    "count": torch.from_numpy(np.array(fields["count"])),
                }
    return header["step"], header["best_acc"], header["extra"]
