"""Weights and state from the JAX package into the port.

The JAX model's variables arrive as a flat ``{path-tuple: np.ndarray}``
dict, the shape ``nnx.state(model).flat_state()`` yields once each
variable is turned into an array, e.g. ``('blocks', 0, 'wqkv', 'packed')``
or ``('conv1', 'layers', 0, 'activation_quantizer', 'min_val')``. This
module takes numpy only; it never imports the JAX package.

The port names its parameters and buffers as the JAX package names its
variables, so a path joined with dots is the port's ``state_dict`` key.
Linear weights are (in, out) in both packages and the W4 weights are the
same hl8 bytes, so those move as they are. Convolutions are the one
layout change (``docs/design.md``, Layouts): the JAX package keeps conv
kernels HWIO and per-out-channel conv statistics (1, 1, 1, O); the port
keeps them OIHW and (O, 1, 1, 1). Every 4-D array therefore moves
through the same transpose (3, 2, 0, 1).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["llama_state_from_numpy", "cnn_state_from_numpy"]


def llama_state_from_numpy(
    flat: Mapping[Tuple, np.ndarray], cfg
) -> Dict[str, torch.Tensor]:
    """The port's ``Llama.state_dict()`` (CPU tensors) for the JAX
    ``Llama`` parameters in ``flat``. ``cfg`` (a ``LlamaConfig``) checks
    the embedding's shape and the block indices. Load it into a port
    model built with the same quantization (``quantize_llama`` or
    ``w4_group``) with ``load_state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if path[0] == "blocks" and not 0 <= int(path[1]) < cfg.n_layers:
            raise ValueError(f"{path}: block index outside n_layers={cfg.n_layers}")
        state[".".join(str(p) for p in path)] = torch.from_numpy(arr.copy())
    embed = state.get("embed")
    if embed is None or tuple(embed.shape) != (cfg.vocab, cfg.dim):
        raise ValueError(f"embed must be ({cfg.vocab}, {cfg.dim}), got "
                         f"{None if embed is None else tuple(embed.shape)}")
    return state


def cnn_state_from_numpy(flat: Mapping[Tuple, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for a JAX CNN's variables in
    ``flat``: the float weights and BN statistics of a plain model, or a
    prepared model's quantizer state (``min_val``, ``max_val``, ``scale``,
    ``zero_point``, ``initialized``) and fused-BN state (``gamma``,
    ``beta``, ``running_*``, ``bn_initialized``). Load it with
    ``load_state_dict`` (strict) into the port model of the same
    architecture and stage."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if arr.ndim == 4:  # HWIO kernel or (1, 1, 1, O) statistics -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        state[".".join(str(p) for p in path)] = torch.from_numpy(np.array(arr, order="C"))
    return state
