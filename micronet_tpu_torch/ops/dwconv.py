"""The integer engine's 3 x 3 depthwise conv in one pass: int8 codes in,
int8 codes (or f32) out.

:func:`dwconv_int8` computes, for the codes ``x`` (N, C, H, W) int8 of a
symmetric depthwise ``IntConv2d`` (groups = C_in = C_out, a 3 x 3 kernel,
dilation 1) and its weight ``w`` as :func:`dw_weight` lays it out:

    acc = the exact int32 depthwise conv of x and w at ``stride`` and
          ``padding`` (zero codes outside the input)
    out = requant_epilogue(acc rows, s_x, w_scale, bias, out_scale, qmin,
                           qmax, chained)

as (N, Ho, Wo, C), the layout of the requant epilogue's (M, C) rows: the
engine takes an NCHW view of it. The epilogue is
``ops/requant_epilogue.py``'s arithmetic, so this route gives the bits of
the block-diagonal one (im2col, an int32 GEMM over the block-diagonal
weight, then the epilogue), without its C-fold work and its 9 C-wide
patch matrix.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/dwconv_int8.cu``, which shares its epilogue's device functions
with ``csrc/requant_epilogue.cu``) or raises; ``x`` is read as NHWC, so an
NHWC-strided NCHW view (the epilogue's output) costs no copy. On a CPU
tensor it runs the plain twin :func:`dwconv_int8_ref`: the CPU route's f64
convolution, exact, then :func:`.requant_epilogue.requant_epilogue_ref`.
The wrapper calls through the registered operator
``torch.ops.micronet_tpu_torch.dwconv_int8`` (with a fake implementation
that gives the output's shape), so that eager code, a captured CUDA graph
and a ``torch.export`` program reach the same kernel. ``dwconv_int8.launches``
counts the operator's runs on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as TF

from .._device import on_cuda
from . import _build
from .requant_epilogue import requant_epilogue_ref

__all__ = ["dw_weight", "dwconv_int8_ref", "dwconv_int8"]

_LIB_SIGNATURES = {
    "mn_dwconv_int8": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
# csrc/dwconv_int8.cu: blocks of _THREADS; the scalar kernel's grid at most _BLOCKS_PER_SM an SM
_THREADS = 256
_BLOCKS_PER_SM = 4


def dw_weight(w_q: torch.Tensor) -> torch.Tensor:
    """(C, 1, 3, 3) int8 codes -> (C, 3, 4) int8: each kernel row's three
    taps and a zero byte, the word the kernel multiplies a row by."""
    return TF.pad(w_q.reshape(w_q.shape[0], 3, 3), (0, 1)).contiguous()


def _out_hw(h: int, w: int, stride, padding) -> Tuple[int, int]:
    return ((h + 2 * padding[0] - 3) // stride[0] + 1, (w + 2 * padding[1] - 3) // stride[1] + 1)


def dwconv_int8_ref(x: torch.Tensor, w: torch.Tensor, s_x: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                    out_scale: torch.Tensor, stride: List[int], padding: List[int], qmin: float,
                    qmax: float, chained: bool) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the exact accumulator as an f64
    convolution, then the epilogue's twin over its (M, C) rows."""
    c = x.shape[1]
    kernel = w[:, :, :3].reshape(c, 1, 3, 3)
    acc = TF.conv2d(x.to(torch.float64), kernel.to(torch.float64), None, tuple(stride),
                    tuple(padding), 1, c).permute(0, 2, 3, 1)
    return requant_epilogue_ref(acc.reshape(-1, c), s_x, w_scale, bias, out_scale, qmin, qmax,
                                chained).reshape(acc.shape)


def _check(xh: torch.Tensor, w: torch.Tensor, s_x, w_scale, bias, out_scale) -> None:
    """Raise on what the kernel does not take: codes not int8 (N, H, W, C)
    contiguous, a weight not (C, 3, 4) int8, or a scale or bias not f32
    and contiguous on the codes' card."""
    dev = xh.device
    if xh.dtype != torch.int8 or xh.dim() != 4 or not xh.is_contiguous():
        raise ValueError(f"x: need int8 (N, H, W, C) codes, got {xh.dtype} {tuple(xh.shape)}")
    c = xh.shape[3]
    _build.check_operand("w", w, torch.int8, dev, shape=(c, 3, 4), align=1)
    _build.check_operand("w_scale", w_scale, torch.float32, dev, shape=(c,))
    if bias is not None:
        _build.check_operand("bias", bias, torch.float32, dev, shape=(c,))
    for name, t in (("s_x", s_x), ("out_scale", out_scale)):
        _build.check_operand(name, t, torch.float32, dev, shape=())


def _card_call(x: torch.Tensor, w: torch.Tensor, s_x: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor], out_scale: torch.Tensor, stride: List[int],
               padding: List[int], qmin: float, qmax: float, chained: bool,
               lib=None) -> torch.Tensor:
    """Launch the kernel on the card (``lib`` defaults to this checkout's
    build); raises on what it does not take. Counts no launch: the
    operator does."""
    n, c, h, wd = x.shape
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        xh = xh.contiguous()
    _check(xh, w, s_x, w_scale, bias, out_scale)
    lib = lib or _build.load("dwconv_int8", _LIB_SIGNATURES)
    (sh, sw), (ph, pw) = stride, padding
    ho, wo = _out_hw(h, wd, stride, padding)
    out = x.new_empty((n, ho, wo, c), dtype=torch.int8 if chained else torch.float32)
    if out.numel() == 0:
        return out
    # the vector kernel indexes its (n, wo, 4 channels) columns in 32 bits
    vector = (c % 4 == 0 and sh == sw and sh in (1, 2) and xh.data_ptr() % 4 == 0
              and w.data_ptr() % 4 == 0 and out.data_ptr() % 16 == 0
              and n * wo * (c // 4) < 2**31)
    units = n * wo * (c // 4) if vector else n * ho * wo * c
    blocks = -(-units // _THREADS)
    if not vector:
        blocks = min(blocks, _BLOCKS_PER_SM * _build.sm_count(x.device))
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    with _build.on_card(x.device):
        rc = lib.mn_dwconv_int8(
            xh.data_ptr(), w.data_ptr(), s_x.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out_scale.data_ptr(), out.data_ptr(), n,
            h, wd, c, ho, wo, sh, sw, ph, pw, int(chained), qmin, qmax, int(vector), blocks,
            stream)
    _build.check(rc, "dwconv_int8")
    return out


def _op(x, w, s_x, w_scale, bias, out_scale, stride, padding, qmin, qmax, chained):
    """The operator's implementation: the kernel on a CUDA tensor (counted
    on :func:`dwconv_int8`), the twin on a CPU tensor."""
    if not on_cuda(x):
        return dwconv_int8_ref(x, w, s_x, w_scale, bias, out_scale, stride, padding, qmin, qmax,
                               chained)
    out = _card_call(x, w, s_x, w_scale, bias, out_scale, stride, padding, qmin, qmax, chained)
    dwconv_int8.launches += 1
    return out


def _out_like(x, w, s_x, w_scale, bias, out_scale, stride, padding, qmin, qmax, chained):
    """The fake implementation: the (N, Ho, Wo, C) output, int8 when
    chained."""
    n, c, h, wd = x.shape
    ho, wo = _out_hw(h, wd, stride, padding)
    return x.new_empty((n, ho, wo, c), dtype=torch.int8 if chained else torch.float32)


# a fragment of ops/int_matmul.py's namespace, defined as the requant epilogue's is
_LIB = torch.library.Library("micronet_tpu_torch", "FRAGMENT")
_LIB.define("dwconv_int8(Tensor x, Tensor w, Tensor s_x, Tensor w_scale, Tensor? bias, "
            "Tensor out_scale, int[] stride, int[] padding, float qmin, float qmax, "
            "bool chained) -> Tensor")
_LIB.impl("dwconv_int8", _op, "CompositeExplicitAutograd")
torch.library.register_fake("micronet_tpu_torch::dwconv_int8", _out_like, lib=_LIB)
_OP = torch.ops.micronet_tpu_torch.dwconv_int8.default


def dwconv_int8(x: torch.Tensor, w: torch.Tensor, s_x: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], out_scale: torch.Tensor, stride=(1, 1),
                padding=(1, 1), qmin: float = -128.0, qmax: float = 127.0,
                chained: bool = True) -> torch.Tensor:
    """x (N, C, H, W) int8 codes; w (C, 3, 4) int8 (:func:`dw_weight`);
    ``w_scale`` (C,) and ``bias`` (C,) or None f32; ``s_x`` and
    ``out_scale`` 0-dim f32 tensors on ``x``'s device -> (N, Ho, Wo, C)
    int8 codes when ``chained`` (clamped to ``[qmin, qmax]``), else f32,
    through the operator ``torch.ops.micronet_tpu_torch.dwconv_int8``. On a
    CUDA tensor this launches the kernel or raises; on a CPU tensor it
    runs the twin :func:`dwconv_int8_ref`."""
    return _OP(x, w, s_x, w_scale, bias, out_scale, [int(v) for v in stride],
               [int(v) for v in padding], float(qmin), float(qmax), bool(chained))


dwconv_int8.launches = 0
