"""Weight-only quantization for the LLM decode path.

Counterpart of ``micronet_tpu/quant/weight_only.py``. Every large 2-D
weight becomes int4 codes packed in the hl8 layout (or plain int8 codes)
plus f32 scales; int4 matmuls run the W4A16 kernel K3
(:func:`..ops.int4_matmul.wo_linear_grouped_hl8`) for both scale layouts,
as the JAX package does; int8 ones are plain PyTorch, as the JAX package
leaves them to XLA.

:func:`quantize_pytree` compresses a nested structure of dicts, lists and
tuples of tensors. Its ``predicate`` receives the path as a tuple of the
plain keys and indices (``("blocks", 0, "w")``), where the JAX package
passes ``jax.tree_util`` key entries (``DictKey``, ``SequenceKey``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.int4_matmul import (
    expand_gscale,
    pack_int4_hl8,
    quantize_int4_weight,
    quantize_int4_weight_grouped,
    round_bf16,
    symmetric_rtn,
    symmetric_rtn_grouped,
    unpack_int4_hl8,
    wo_linear_grouped_hl8,
)

__all__ = ["WOTensor", "WOLinear", "wo_quantize_linear", "quantize_pytree", "dequantize_leaf",
           "pytree_bytes"]


@dataclasses.dataclass
class WOTensor:
    """A weight-only-quantized (K, N) tensor.

    ``group == 0``: per-column scale (1, N); ``group > 0``: scales
    (K/group, N). ``bits == 4``: (K/2, N) hl8-packed nibbles (K padded to
    even); ``bits == 8``: plain (K, N) int8 codes."""

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    group: int = 0
    bits: int = 4

    def _codes(self) -> torch.Tensor:
        if self.bits == 8:
            return self.packed.to(torch.float32)
        return unpack_int4_hl8(self.packed)[: self.k].to(torch.float32)

    def dequantize(self) -> torch.Tensor:
        w = self._codes()
        if self.group:
            return w * expand_gscale(self.scale, self.group)[: self.k]
        return w * self.scale

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits == 8:
            # bf16 operands, f32 products and sums
            return round_bf16(x.to(torch.float32)) @ round_bf16(self.dequantize())
        full = self.packed.shape[0] * 2 == self.k
        if self.group and full and self.packed.shape[0] % self.group == 0:
            return wo_linear_grouped_hl8(x, self.packed, self.scale)
        if not self.group and full and self.packed.shape[0] % 128 == 0:
            # per-column scales ride the grouped kernel as 128-row groups
            gs = self.scale.reshape(1, -1).expand(self.k // 128, -1).contiguous()
            return wo_linear_grouped_hl8(x, self.packed, gs)
        return x @ self.dequantize()  # odd K or a group not dividing K/2


def _quantize_2d(w: torch.Tensor, group: int = 0, bits: int = 4) -> WOTensor:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k = w.shape[0]
    if bits == 8:
        if group and k % group == 0:
            w_q, scale = symmetric_rtn_grouped(w, 127.0, group)
        else:
            group = 0
            w_q, scale = symmetric_rtn(w, 127.0, axis=0)
        return WOTensor(packed=w_q, scale=scale, k=k, group=group, bits=8)
    if group and k % group == 0:
        w_q, scale = quantize_int4_weight_grouped(w, group)
    else:
        group = 0
        w_q, scale = quantize_int4_weight(w, axis=0)
    if k % 2:
        w_q = torch.nn.functional.pad(w_q, (0, 0, 0, 1))
    return WOTensor(packed=pack_int4_hl8(w_q), scale=scale, k=k, group=group)


class WOLinear(nn.Module):
    """Weight-only int4/int8 linear; bias in f32. ``packed`` and
    ``scale`` are buffers, so they ride ``state_dict``."""

    def __init__(self, wo: WOTensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("packed", wo.packed)
        self.register_buffer("scale", wo.scale)
        self.k, self.group, self.bits = wo.k, wo.group, wo.bits
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wo = WOTensor(self.packed, self.scale, self.k, self.group, self.bits)
        out = wo.matmul(x)
        if self.bias is not None:
            out = out + self.bias
        return out


def wo_quantize_linear(linear, group: int = 0, bits: int = 4) -> WOLinear:
    """Convert a :class:`..nn.modules.Linear` ((in, out) weight) to
    weight-only int4 or int8; ``group > 0`` uses block scales."""
    with torch.no_grad():
        w = linear.weight.detach()
        b = None if linear.bias is None else linear.bias.detach()
        return WOLinear(_quantize_2d(w, group, bits), b)


def _map_with_path(fn: Callable[[Tuple, Any], Any], tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples,
    keeping the containers' types."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_with_path(fn, v, path + (k,))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def quantize_pytree(params: Any, *, min_size: int = 1 << 16,
                    predicate: Optional[Callable[[Tuple, torch.Tensor], bool]] = None,
                    group: int = 0, bits: int = 4) -> Any:
    """Replace every floating 2-D tensor of ``params`` with at least
    ``min_size`` elements (and, if given, ``predicate(path, leaf)`` true)
    by a :class:`WOTensor`, quantized along axis 0 (the contraction axis
    of ``x @ w``). ``group > 0`` selects group scales; a leaf whose K the
    group does not divide falls back to per-column. ``bits`` is 4 or 8."""

    def visit(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() == 2 and leaf.is_floating_point()
                and leaf.numel() >= min_size and (predicate is None or predicate(path, leaf))):
            return _quantize_2d(leaf, group, bits)
        return leaf

    return _map_with_path(visit, params)


def dequantize_leaf(leaf: Any) -> Any:
    """The inverse map of :func:`quantize_pytree` for one leaf."""
    return leaf.dequantize() if isinstance(leaf, WOTensor) else leaf


def pytree_bytes(params: Any) -> int:
    """Storage bytes of the tensors in ``params`` (a :class:`WOTensor`
    counts its codes and scales)."""
    total = 0

    def count(_, leaf):
        nonlocal total
        for t in (leaf.packed, leaf.scale) if isinstance(leaf, WOTensor) else (leaf,):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
        return leaf

    _map_with_path(count, params)
    return total
