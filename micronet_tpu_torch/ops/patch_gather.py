"""The integer engine's data movement in front of its GEMMs, one pass an
operand: a conv's patch matrix and the channel shuffle of int8 codes.

:func:`patch_matrix` turns the codes ``x`` (N, C, H, W), an NCHW view of
NHWC memory as every engine layer emits them, into the (N*Ho*Wo,
kh*kw*C) GEMM operand in (kh, kw, c) column order for any kernel size,
stride, padding and dilation, padding written as zero codes. With a
``scale`` (a 0-dim f32 tensor) it writes the dequantized patches instead,
``float(code) * scale`` in f32, the first layer's f32 operand.

:func:`patch_shuffle` shuffles the channels of int8 codes: output channel
``k * g + r`` is input channel ``r * (C / g) + k``. It writes NHWC memory
and returns an NCHW view of it, so a 1 x 1 conv after it reads its
operand as a view and a 3 x 3 conv takes one :func:`patch_matrix` pass.

On a CUDA tensor each launches its hand-written kernel
(``csrc/patch_gather.cu``) or raises; ``x`` is read as NHWC, so an input
that is not NHWC-backed takes one NHWC copy first (no layer of the
benchmark's engines needs it). On a CPU tensor each runs its plain twin,
:func:`patch_matrix_ref` (the engine's unfold, permute and reshape) and
:func:`patch_shuffle_ref` (the reshape and transpose of
``nn/functional.py::channel_shuffle``), which give the same bytes. The
wrappers call through the registered operators
``torch.ops.micronet_tpu_torch.patch_matrix`` and ``patch_shuffle`` (each
with a fake implementation that gives the output's shape), so that eager
code, a captured CUDA graph and a ``torch.export`` program reach the same
kernels. ``launches``, a module attribute, counts both operators' runs on
a CUDA tensor (a Python call each): a CUDA graph's replay makes no Python
call and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as TF

from .._device import on_cuda
from . import _build

__all__ = ["out_hw", "patch_matrix_ref", "patch_matrix", "patch_shuffle_ref", "patch_shuffle"]

_LIB_SIGNATURES = {
    "mn_patch_matrix": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 + [ctypes.c_void_p],
    "mn_patch_shuffle": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "mn_patch_blocks_per_sm": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}
# csrc/patch_gather.cu: blocks of _THREADS, a persistent grid of one wave (the blocks the SMs
# hold at once, :func:`_slots`); the f32 variant's columns a thread; the shuffle's tiles of
# _TILE_BYTES of whole pixel rows; mn_patch_blocks_per_sm's kernel variants
_THREADS = 256
_F32_COLUMNS = 4
_TILE_BYTES = 16384
_F32, _SHUFFLE_BYTES, _SHUFFLE_TILED = 0, 2, 3
_INT32_MAX = 2**31 - 1

launches = 0


def out_hw(h: int, w: int, kernel: Sequence[int], stride: Sequence[int],
           padding: Sequence[int], dilation: Sequence[int]) -> Tuple[int, int]:
    """The output's (Ho, Wo) of a conv over an (H, W) input."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    return ((h + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
            (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1)


def patch_matrix_ref(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                     padding: Sequence[int], dilation: Sequence[int],
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (N, C, H, W) -> the (N*Ho*Wo,
    kh*kw*C) patch matrix in (kh, kw, c) column order, padding zero codes;
    with ``scale``, of ``x.to(float32) * scale``."""
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = out_hw(h, w, kernel, stride, padding, dilation)
    if scale is not None:
        x = x.to(torch.float32) * scale
    xh = x.permute(0, 2, 3, 1)  # NHWC
    if ph or pw:
        xh = TF.pad(xh, (0, 0, pw, pw, ph, ph))
    if (kh, kw) == (1, 1):
        return xh[:, ::sh, ::sw][:, :ho, :wo].reshape(n * ho * wo, c)
    p = xh.unfold(1, dh * (kh - 1) + 1, sh).unfold(2, dw * (kw - 1) + 1, sw)
    p = p[..., ::dh, ::dw]  # (N, Ho, Wo, C, kh, kw)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * c)


def patch_shuffle_ref(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the channel shuffle of (N, C, H,
    W) as a reshape and a transpose, NCHW-contiguous out."""
    n, c = x.shape[:2]
    return x.reshape(n, groups, c // groups, *x.shape[2:]).transpose(1, 2).reshape(x.shape)


def _nhwc_codes(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) int8 -> its (N, H, W, C) contiguous codes: a view where
    ``x`` is NHWC-backed, else one NHWC copy."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x: need int8 (N, C, H, W) codes, got {x.dtype} {tuple(x.shape)}")
    xh = x.permute(0, 2, 3, 1)
    return xh if xh.is_contiguous() else xh.contiguous()


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """The widest chunk, 16, 4 or 1 bytes, that divides C and every base."""
    for v in (16, 4):
        if c % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


def _plan(units: int, cpr: int, slots: int) -> int:
    """The grid for ``units`` chunks, ``cpr`` of them a row: its thread
    count a multiple of ``cpr`` (``cpr / gcd(cpr, _THREADS)`` blocks a
    step), so that every thread keeps its chunk of the row down the rows;
    a thread a chunk where that fits in one wave of ``slots`` blocks, else
    one wave rounded down to whole steps (at least one step)."""
    step = cpr // math.gcd(cpr, _THREADS)
    need = -(-max(units, 1) // _THREADS)
    return max(step, min(-(-need // step) * step, slots // step * step))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, variant: int) -> int:
    lib = _build.load("patch_gather", _LIB_SIGNATURES)
    blocks = ctypes.c_int(0)
    with _build.on_card(torch.device("cuda", index)):
        _build.check(lib.mn_patch_blocks_per_sm(variant, ctypes.byref(blocks)),
                     "patch_gather occupancy")
    return max(1, blocks.value)


def _slots(device: torch.device, variant: int) -> int:
    """The blocks of the kernel ``variant`` that the card holds at once
    (its occupancy times its SMs), read once per card and variant."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return _blocks_per_sm(index, variant) * _build.sm_count(device)


def _matrix_call(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int], dilation: Sequence[int],
                 scale: Optional[torch.Tensor], lib=None) -> torch.Tensor:
    """Launch the patch-matrix kernel on the card (``lib`` defaults to this
    checkout's build); raises on what it does not take. Counts no launch:
    the operator does."""
    xh = _nhwc_codes(x)
    if scale is not None:
        _build.check_operand("scale", scale, torch.float32, xh.device, shape=())
    n, h, w, c = xh.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = out_hw(h, w, kernel, stride, padding, dilation)
    m, k = n * max(ho, 0) * max(wo, 0), kh * kw * c
    out = xh.new_empty((m, k), dtype=torch.int8 if scale is None else torch.float32)
    if out.numel() == 0:
        return out
    if m > _INT32_MAX:
        raise ValueError(f"patch matrix: {m} rows over the kernel's 32-bit row index")
    vec = _F32_COLUMNS if scale is not None else _vec(c, xh, out)
    cpr = -(-k // vec)
    blocks = _plan(m * cpr, cpr, _slots(xh.device, _F32 if scale is not None else vec))
    if blocks * _THREADS > _INT32_MAX:
        raise ValueError(f"patch matrix: a row of {cpr} chunks needs too large a grid")
    lib = lib or _build.load("patch_gather", _LIB_SIGNATURES)
    stream = torch._C._cuda_getCurrentRawStream(xh.device.index)
    with _build.on_card(xh.device):
        rc = lib.mn_patch_matrix(xh.data_ptr(), out.data_ptr(),
                                 None if scale is None else scale.data_ptr(), n, h, w, c, ho,
                                 wo, kh, kw, sh, sw, ph, pw, dh, dw, vec, blocks, stream)
    _build.check(rc, "patch_matrix")
    return out


def _shuffle_call(x: torch.Tensor, groups: int, lib=None) -> torch.Tensor:
    """Launch the shuffle kernel on the card; raises on what it does not
    take. Returns (N, H, W, C) contiguous codes. Counts no launch."""
    xh = _nhwc_codes(x)
    n, h, w, c = xh.shape
    if groups < 1 or c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    out = torch.empty_like(xh, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    pixels = n * h * w
    tiled = (c % 16 == 0 and c <= _TILE_BYTES and xh.data_ptr() % 16 == 0
             and out.data_ptr() % 16 == 0)
    if tiled:
        blocks = min(-(-pixels // (_TILE_BYTES // c)), _slots(xh.device, _SHUFFLE_TILED))
    else:
        blocks = _plan(pixels * c, c, _slots(xh.device, _SHUFFLE_BYTES))
    if blocks * _THREADS > _INT32_MAX:
        raise ValueError(f"patch shuffle: {c} channels need too large a grid")
    lib = lib or _build.load("patch_gather", _LIB_SIGNATURES)
    stream = torch._C._cuda_getCurrentRawStream(xh.device.index)
    with _build.on_card(xh.device):
        rc = lib.mn_patch_shuffle(xh.data_ptr(), out.data_ptr(), pixels, c, groups, int(tiled),
                                  blocks, stream)
    _build.check(rc, "patch_shuffle")
    return out


def _count() -> None:
    global launches
    launches += 1


def _matrix_op(x, kernel, stride, padding, dilation, scale):
    """The operator's implementation: the kernel on a CUDA tensor (counted
    in :data:`launches`), the twin on a CPU tensor (contiguous, as the
    kernel's output)."""
    if not on_cuda(x):
        return patch_matrix_ref(x, kernel, stride, padding, dilation, scale).contiguous()
    out = _matrix_call(x, kernel, stride, padding, dilation, scale)
    _count()
    return out


def _matrix_like(x, kernel, stride, padding, dilation, scale):
    """The fake implementation: the (N*Ho*Wo, kh*kw*C) output, f32 with a
    scale."""
    n, c, h, w = x.shape
    ho, wo = out_hw(h, w, kernel, stride, padding, dilation)
    return x.new_empty((n * ho * wo, kernel[0] * kernel[1] * c),
                       dtype=torch.int8 if scale is None else torch.float32)


def _shuffle_op(x, groups):
    """The operator's implementation: (N, H, W, C) codes, from the kernel on
    a CUDA tensor (counted in :data:`launches`), from the twin on a CPU
    tensor."""
    if not on_cuda(x):
        return patch_shuffle_ref(x, groups).permute(0, 2, 3, 1).contiguous()
    out = _shuffle_call(x, groups)
    _count()
    return out


def _shuffle_like(x, groups):
    """The fake implementation: the (N, H, W, C) output."""
    n, c, h, w = x.shape
    return x.new_empty((n, h, w, c))


# a fragment of ops/int_matmul.py's namespace, defined as the requant epilogue's is
_LIB = torch.library.Library("micronet_tpu_torch", "FRAGMENT")
_LIB.define("patch_matrix(Tensor x, int[] kernel, int[] stride, int[] padding, int[] dilation, "
            "Tensor? scale) -> Tensor")
_LIB.impl("patch_matrix", _matrix_op, "CompositeExplicitAutograd")
torch.library.register_fake("micronet_tpu_torch::patch_matrix", _matrix_like, lib=_LIB)
_LIB.define("patch_shuffle(Tensor x, int groups) -> Tensor")
_LIB.impl("patch_shuffle", _shuffle_op, "CompositeExplicitAutograd")
torch.library.register_fake("micronet_tpu_torch::patch_shuffle", _shuffle_like, lib=_LIB)
_MATRIX = torch.ops.micronet_tpu_torch.patch_matrix.default
_SHUFFLE = torch.ops.micronet_tpu_torch.patch_shuffle.default


def _ints(v: Sequence[int]) -> List[int]:
    return [int(i) for i in v]


def patch_matrix(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int] = (1, 1),
                 padding: Sequence[int] = (0, 0), dilation: Sequence[int] = (1, 1),
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, C, H, W) int8 codes -> the (N*Ho*Wo, kh*kw*C) contiguous patch
    matrix in (kh, kw, c) column order, int8 with zero codes for padding;
    with ``scale`` (0-dim f32 on ``x``'s device) f32 ``float(code) *
    scale``, padding 0. Through the operator
    ``torch.ops.micronet_tpu_torch.patch_matrix``: on a CUDA tensor the
    kernel or a raise, on a CPU tensor the twin :func:`patch_matrix_ref`."""
    return _MATRIX(x, _ints(kernel), _ints(stride), _ints(padding), _ints(dilation), scale)


def patch_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x (N, C, H, W) int8 codes -> the channel shuffle of ``groups``
    groups, an NCHW view of NHWC memory, through the operator
    ``torch.ops.micronet_tpu_torch.patch_shuffle``: on a CUDA tensor the
    kernel or a raise, on a CPU tensor the twin :func:`patch_shuffle_ref`
    laid out as NHWC."""
    return _SHUFFLE(x, int(groups)).permute(0, 3, 1, 2)
