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
keeps them OIHW and (O, 1, 1, 1), so a 4-D array moves through the
transpose (3, 2, 0, 1). Transposed-conv kernels are the exception: the
JAX package keeps them (kh, kw, in, out // groups), the port torch's
(in, out // groups, kh, kw), a transpose (2, 3, 0, 1). Where ``in ==
out // groups`` the shape cannot tell the two apart, so the layout comes
from the module: :func:`transposed_kernel_keys` of the port model names
the tensors of the second layout (each module lists them in
``transposed_kernels``).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["llama_state_from_numpy", "tiny_decoder_state_from_numpy", "cnn_state_from_numpy",
           "transposed_kernel_keys"]

# JAX layout -> port layout of a 4-D array, and back
HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)
KKIO_TO_IOKK = (2, 3, 0, 1)  # transposed-conv kernels, both ways


def transposed_kernel_keys(model: Optional[nn.Module]) -> FrozenSet[str]:
    """``state_dict`` keys of ``model``'s transposed-conv kernels: every
    tensor a module names in its ``transposed_kernels``."""
    if model is None:
        return frozenset()
    return frozenset(f"{name}.{attr}" if name else attr
                     for name, m in model.named_modules()
                     for attr in getattr(m, "transposed_kernels", ()))


def _decoder_state(flat: Mapping[Tuple, np.ndarray], depth: int,
                   shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """The state_dict (CPU tensors) of a decoder's variables in ``flat``,
    each path joined with dots; raises on a block index outside ``depth``
    or a tensor of ``shapes`` missing or of another shape."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        if path[0] == "blocks" and not 0 <= int(path[1]) < depth:
            raise ValueError(f"{path}: block index outside depth={depth}")
        state[".".join(str(p) for p in path)] = torch.from_numpy(np.array(value))
    for name, shape in shapes.items():
        got = state.get(name)
        if got is None or tuple(got.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{None if got is None else tuple(got.shape)}")
    return state


def llama_state_from_numpy(
    flat: Mapping[Tuple, np.ndarray], cfg
) -> Dict[str, torch.Tensor]:
    """The port's ``Llama.state_dict()`` (CPU tensors) for the JAX
    ``Llama`` parameters in ``flat``. ``cfg`` (a ``LlamaConfig``) checks
    the embedding's shape and the block indices. Load it into a port
    model built with the same quantization (``quantize_llama`` or
    ``w4_group``) with ``load_state_dict``."""
    return _decoder_state(flat, cfg.n_layers, {"embed": (cfg.vocab, cfg.dim)})


def tiny_decoder_state_from_numpy(
    flat: Mapping[Tuple, np.ndarray], model: nn.Module
) -> Dict[str, torch.Tensor]:
    """The port's ``TinyDecoder.state_dict()`` (CPU tensors) for the JAX
    ``TinyDecoder`` variables in ``flat``: float, W4 (``quantize_decoder``:
    the packed codes and scales as they are) or MoE (the router, the
    experts, and after ``quantize_()`` their int8 codes and scales).
    ``model`` (the port's ``TinyDecoder``) checks the embedding's and the
    position table's shapes and the block indices. Load it with
    ``load_state_dict`` into a port model of the same form."""
    return _decoder_state(flat, model.depth, {"embed": (model.vocab, model.dim),
                                              "pos": (model.max_seq, model.dim)})


def cnn_state_from_numpy(flat: Mapping[Tuple, np.ndarray],
                         model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) for a JAX CNN's variables in
    ``flat``: the float weights and BN statistics of a plain model, or a
    prepared model's quantizer state (``min_val``, ``max_val``, ``scale``,
    ``zero_point``, ``initialized``) and fused-BN state (``gamma``,
    ``beta``, ``running_*``, ``bn_initialized``), or a frozen engine's
    (``w_q``, ``w_scale``, ``act_scale``, ``act_zero_point``, ``w_zp``,
    ...). Load it with ``load_state_dict`` (strict) into the port model of
    the same architecture and stage. ``model`` is that port model: it says
    which kernels are transposed convolutions' (needed only where the net
    has one)."""
    transposed = transposed_kernel_keys(model)
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key = ".".join(str(p) for p in path)
        arr = np.asarray(value)
        if arr.ndim == 4:  # a kernel, or (1, 1, 1, O) statistics
            arr = arr.transpose(KKIO_TO_IOKK if key in transposed else HWIO_TO_OIHW)
        state[key] = torch.from_numpy(np.array(arr, order="C"))
    return state
