"""The integer engine's conv epilogue in one pass: an int32 (or f32)
accumulator in, int8 codes (or f32) out.

:func:`requant_epilogue` computes, for the (M, O) accumulator rows ``acc``
of a symmetric ``IntConv2d`` (a view of its GEMM's output, rows any
stride apart), per-channel ``w_scale`` and ``bias`` and 0-dim ``s_x`` and
``out_scale``:

    v   = f32(acc) * (s_x * w_scale[o])                  (int32 acc only)
    v   = v + bias[o]                                     (with a bias)
    out = v                                               (f32; unchained)
    out = clamp(round_half_away(v / out_scale), qmin, qmax)    (int8; chained)

An f32 ``acc`` (the first layer's f32 GEMM over dequantized codes, which
is scaled already) takes no ``w_scale``. On the CPU ``acc`` may also be
the CPU route's exact f64 accumulator, which the twin casts to f32 as
the kernel casts int32. The output is (M, O) contiguous.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/requant_epilogue.cu``) or raises; on a CPU tensor it runs the
plain twin :func:`requant_epilogue_ref`, the engine's chain of PyTorch
operations, which does the same f32 operations in the same order, so the
two agree bit for bit. The wrapper calls through the registered operator
``torch.ops.micronet_tpu_torch.requant_epilogue``, defined by
``_build.operator`` (with a fake implementation that gives the output's
shape). ``requant_epilogue.launches`` counts the operator's runs on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..quant.rounding import round_half_away
from . import _build

__all__ = ["requant", "requant_epilogue_ref", "requant_epilogue"]

_LIB_SIGNATURES = {
    "mn_requant_epilogue": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                               ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
# csrc/requant_epilogue.cu: blocks of _THREADS, a persistent grid of at most _BLOCKS_PER_SM an SM
_THREADS = 256
_BLOCKS_PER_SM = 4


def requant(v: torch.Tensor, out_scale: torch.Tensor, qmin: float, qmax: float) -> torch.Tensor:
    """``clamp(round_half_away(v / out_scale), qmin, qmax)`` as int8 codes
    (a true division: ``out_scale`` is a tensor, a scale or one per
    channel)."""
    return torch.clamp(round_half_away(v / out_scale), qmin, qmax).to(torch.int8)


def requant_epilogue_ref(acc: torch.Tensor, s_x: torch.Tensor, w_scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], out_scale: torch.Tensor, qmin: float,
                         qmax: float, chained: bool) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the engine's chain over the (M, O)
    rows ``acc``, what the JAX package's ``IntConv2d._epilogue`` computes."""
    out = acc.to(torch.float32)
    if w_scale is not None:
        out = out * (s_x * w_scale)
    if bias is not None:
        out = out + bias
    return requant(out, out_scale, qmin, qmax) if chained else out


def _plan(m: int, o: int, vector: bool, sms: int) -> int:
    """The grid of a call: the vector kernel's (a thread per 4 channels of
    a row) a multiple of ``(O / 4) / gcd(O / 4, _THREADS)`` blocks, so that
    its thread count is a multiple of O / 4 and every thread keeps its 4
    channels down the rows; the scalar kernel's (a thread per element)
    any. Both at most ``_BLOCKS_PER_SM`` blocks an SM, then grid-stride."""
    units = m * (o // 4 if vector else o)
    blocks = min(-(-units // _THREADS), _BLOCKS_PER_SM * sms)
    if not vector:
        return blocks
    step = (o // 4) // math.gcd(o // 4, _THREADS)
    return -(-blocks // step) * step


def check_operands(dev: torch.device, o: int, s_x: torch.Tensor, w_scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], out_scale: torch.Tensor) -> None:
    """Raise unless the epilogue's operands are f32 and contiguous on
    ``dev``: ``w_scale`` and ``bias`` (O,) or None, ``s_x`` and
    ``out_scale`` 0-dim."""
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None:
            _build.check_operand(name, t, torch.float32, dev, shape=(o,))
    for name, t in (("s_x", s_x), ("out_scale", out_scale)):
        _build.check_operand(name, t, torch.float32, dev, shape=())


def _check(acc: torch.Tensor, s_x: torch.Tensor, w_scale: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], out_scale: torch.Tensor) -> None:
    """Raise on what the kernel does not take: ``acc`` not (M, O) int32
    (with ``w_scale``) or f32 (without) with unit column stride, or a
    scale or bias not f32 and contiguous on ``acc``'s card."""
    m, o = acc.shape if acc.dim() == 2 else (0, 0)
    if acc.dim() != 2 or (o > 1 and acc.stride(1) != 1) or (m > 1 and acc.stride(0) < o):
        raise ValueError(f"acc: need (M, O) rows with unit column stride, got shape "
                         f"{tuple(acc.shape)}, strides {acc.stride()}")
    if (acc.dtype, w_scale is None) not in ((torch.int32, False), (torch.float32, True)):
        raise ValueError(f"acc: need int32 with w_scale or float32 without, got {acc.dtype} "
                         f"{'without' if w_scale is None else 'with'} w_scale")
    check_operands(acc.device, o, s_x, w_scale, bias, out_scale)


def _card_call(acc: torch.Tensor, s_x: torch.Tensor, w_scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], out_scale: torch.Tensor, qmin: float, qmax: float,
               chained: bool) -> torch.Tensor:
    """Launch the kernel on the card; raises on what it does not take.
    Counts no launch: the operator does."""
    _check(acc, s_x, w_scale, bias, out_scale)
    lib = _build.load("requant_epilogue", _LIB_SIGNATURES)
    m, o = acc.shape
    out = acc.new_empty((m, o), dtype=torch.int8 if chained else torch.float32)
    if m == 0 or o == 0:
        return out
    ld = acc.stride(0)
    vector = o % 4 == 0 and ld % 4 == 0 and acc.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    blocks = _plan(m, o, vector, _build.sm_count(acc.device))
    _build.launch(lib.mn_requant_epilogue, acc.device, "requant_epilogue",
                  acc.data_ptr(), int(acc.dtype == torch.int32), ld, s_x.data_ptr(),
                  None if w_scale is None else w_scale.data_ptr(),
                  None if bias is None else bias.data_ptr(), out_scale.data_ptr(),
                  out.data_ptr(), m, o, int(chained), qmin, qmax, int(vector), blocks)
    return out


def _out_like(acc: torch.Tensor, s_x, w_scale, bias, out_scale, qmin, qmax,
              chained: bool) -> torch.Tensor:
    """The fake implementation: the (M, O) output, int8 when chained."""
    return acc.new_empty(tuple(acc.shape), dtype=torch.int8 if chained else torch.float32)


def requant_epilogue(acc: torch.Tensor, s_x: torch.Tensor, w_scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], out_scale: torch.Tensor, qmin: float = -128.0,
                     qmax: float = 127.0, chained: bool = True) -> torch.Tensor:
    """acc (M, O) int32 with ``w_scale`` (O,), or f32 without; ``bias``
    (O,) or None; ``s_x`` and ``out_scale`` 0-dim f32 tensors on ``acc``'s
    device -> (M, O) int8 codes when ``chained`` (clamped to ``[qmin,
    qmax]``), else f32, through the operator
    ``torch.ops.micronet_tpu_torch.requant_epilogue``. On a CUDA tensor
    this launches the kernel or raises; on a CPU tensor it runs the twin
    :func:`requant_epilogue_ref`."""
    return _OP(acc, s_x, w_scale, bias, out_scale, float(qmin), float(qmax), bool(chained))


_OP = _build.operator(
    "requant_epilogue(Tensor acc, Tensor s_x, Tensor? w_scale, Tensor? bias, "
    "Tensor out_scale, float qmin, float qmax, bool chained) -> Tensor",
    _card_call, requant_epilogue_ref, _out_like, requant_epilogue)
