"""Weights from the JAX package into the port.

The JAX model's parameters arrive as a flat ``{path-tuple: np.ndarray}``
dict, the shape ``nnx.state(model).flat_state()`` yields once each
variable is turned into an array, e.g. ``('blocks', 0, 'wqkv', 'packed')``,
``('blocks', 0, 'attn_norm', 'weight')``, ``('embed',)`` or
``('lm_head', 'packed')``. This module takes numpy only; it never
imports the JAX package.

Both packages keep a Linear weight as (in, out) and the W4 weights as
hl8-packed (K/2, N) int8 with (K/g, N) f32 scales, so every tensor moves
as it is; only the key changes (``blocks.0.wqkv.packed``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["llama_state_from_numpy"]


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
