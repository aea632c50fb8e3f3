"""Int8 matmuls with the activation quantize and the dequantize fused: the
counterpart of ``micronet_tpu/ops/int_matmul.py``.

K1, :func:`int8_matmul_dequant`, computes for x (M, K) f32 and int8
weights w_q (K, N) with per-column scales:

    q   = clamp(round_half_away(x / s_x) - zp, qmin, qmax)     (int8)
    acc = q . w_q + int(zp) * colsum(w_q)                      (int32)
    out = f32(acc) * (s_x * w_scale[n])

``qmin``/``qmax`` are the activation range (narrower than int8 at A4).

K2, :func:`binary_act_matmul`, is the wbwtab product: binary activations
times ternary (or binary) weights times a per-column alpha:

    q   = where(x >= 0, 1, -1)      (int8; 0 and -0.0 -> +1, NaN -> -1)
    acc = q . w_q                    (int32, w_q in {-1, 0, +1})
    out = f32(acc) * alpha[n]

On a CUDA tensor each wrapper launches its hand-written kernels
(``csrc/int_matmul.cu``, on the int8 tensor cores) or raises; on a CPU
tensor it runs its plain twin (``*_ref``), which does the same f32
operations in the same order. Two regimes, picked by :func:`_k1_regime`
from M, K, N and the SM count: "small" (one launch, ``mma.sync``, the
quantize fused) and "gemm" (a codes pre-pass, a K-major weight pre-pass,
then a wgmma GEMM). Integer sums are exact in any order, so both regimes
and the twin agree bit for bit. Every pad (k past K, rows or columns past
the matrix) holds code 0: padding x with zeros would binarize them to +1.

Both wrappers call through registered PyTorch operators,
``torch.ops.micronet_tpu_torch.int8_matmul_dequant`` and
``...binary_act_matmul`` (each with a fake implementation that gives the
(M, N) f32 output's shape), so that eager code, a captured CUDA graph and a
``torch.export`` program reach the same kernel. A wrapper's ``launches``
counts the operator's runs on a CUDA tensor (a Python call each): a CUDA
graph's replay makes no Python call and counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from .._device import on_cuda
from ..quant.rounding import round_half_away
from . import _build

__all__ = ["quantize_int8", "int8_matmul_dequant_ref", "int8_matmul_dequant", "int8_linear",
           "binary_act_matmul_ref", "binary_act_matmul"]

Scalar = Union[float, torch.Tensor]


def quantize_int8(x: torch.Tensor, scale: Scalar, zero_point: Scalar, qmin: float,
                  qmax: float) -> torch.Tensor:
    """``clamp(round_half_away(x / s) - zp, qmin, qmax)`` as int8; the
    dequant is ``(q + zp) * s``."""
    q = round_half_away(x.to(torch.float32) / scale) - zero_point
    return torch.clamp(q, qmin, qmax).to(torch.int8)


def _scalar(v: Scalar, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor) and v.dim() == 0 and v.dtype == torch.float32 and (
            v.device == device):
        return v
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def int8_matmul_dequant_ref(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                            x_scale: Scalar, x_zero_point: Scalar, qmin: float = -128.0,
                            qmax: float = 127.0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, what the JAX oracle
    ``int8_matmul_dequant_xla`` computes. The integer product runs in f64,
    exact for every int32 accumulator, on the CPU and on the card."""
    s_x = _scalar(x_scale, x.device)
    zp = _scalar(x_zero_point, x.device)
    q = quantize_int8(x, s_x, zp, qmin, qmax)
    acc = (q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    colsum = torch.sum(w_q.to(torch.int32), dim=0)
    acc = acc + zp.to(torch.int32) * colsum[None, :]
    w_scale = torch.broadcast_to(w_scale.to(torch.float32), (w_q.shape[1],))
    return acc.to(torch.float32) * (s_x * w_scale)[None, :]


_LIB_SIGNATURES = {
    "mn_int8_matmul_dequant_small": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "mn_int8_matmul_dequant_gemm": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "mn_binary_act_matmul_small": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "mn_binary_act_matmul_gemm": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
# The largest K: |q . w| <= K * 128 * 128 must fit int32 (2**31 - 1), so every int32 sum of the
# kernels is exact whatever its order
_K_MAX = (2**31 - 1) // (128 * 128)
# csrc/int_matmul.cu's tiles: the small regime's block takes _SMALL_ROWS x _SMALL_COLS of out,
# the GEMM's _GEMM_ROWS x _GEMM_COLS; K is padded to _K_ALIGN for the GEMM's TMA rows; the
# weight pre-pass transposes _WT_TILE x _WT_TILE tiles. Every grid is 1-D.
_SMALL_ROWS, _SMALL_COLS = 16, 32
_GEMM_ROWS, _GEMM_COLS = 128, 256
_K_ALIGN = 16
_WT_TILE = 64
_PRE_BLOCKS = 8192
# the small regime's share of work an SM below which it beats the GEMM's three launches (an
# H100's device times: tools/int8_regimes.py)
_SMALL_MACS = 2**18
_GRID_MAX = 2**31 - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _k1_regime(m: int, k: int, n: int, sms: int) -> str:
    """K1's and K2's regime from M, K, N and the card's SM count alone
    (never x or w): "small" (one launch, mma.sync, the quantize fused) for
    N <= 32 or up to ``_SMALL_MACS`` multiply-adds an SM; else "gemm" (the
    pre-passes, then the wgmma GEMM, about 0.01 ms at least for its three
    launches). Integer sums are exact in any order, so both regimes give
    the same bits: the boundary is a speed choice only."""
    return "small" if n <= _SMALL_COLS or m * k * n <= _SMALL_MACS * sms else "gemm"


def _plan(m: int, k: int, n: int, regime: str, sms: int) -> dict:
    """What a call of ``regime`` launches: the 1-D grid of each kernel and
    how many kernels, and for the GEMM Kp (K rounded up to 16, TMA's
    16-byte row strides) and the scratch shapes (int8 codes (M, Kp) and wT
    (N, Kp))."""
    if regime == "small":
        return dict(grids=(_cdiv(m, _SMALL_ROWS) * _cdiv(n, _SMALL_COLS),), launches=1)
    kp = _cdiv(k, _K_ALIGN) * _K_ALIGN
    # the codes pre-pass: a thread per 4 codes, at most _PRE_BLOCKS blocks of 256 (grid-stride);
    # the GEMM: a persistent block per SM at most
    return dict(grids=(min(_cdiv(m * kp // 4, 256), _PRE_BLOCKS),
                       _cdiv(kp, _WT_TILE) * _cdiv(n, _WT_TILE),
                       min(_cdiv(m, _GEMM_ROWS) * _cdiv(n, _GEMM_COLS), sms)),
                kp=kp, codes=(m, kp), wt=(n, kp), launches=3)


def check_limits(m: int, k: int, n: int) -> None:
    """Raise ValueError on a call the kernels cannot take: an empty matrix,
    K past ``_K_MAX`` (an int32 sum could overflow), a grid past 2^31 - 1
    blocks in either regime, or codes (M, Kp) past 2^31 - 1 units of 4
    (the codes pre-pass's 32-bit index)."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"kernel needs M, K, N > 0 (M={m}, K={k}, N={n})")
    if k > _K_MAX:
        raise ValueError(f"K={k} > {_K_MAX}: an int32 sum of K int8 x int8 products could "
                         "overflow")
    # the GEMM's own grid and the codes pre-pass's are capped (SMs, _PRE_BLOCKS), so the SM
    # count does not matter here
    if max(_plan(m, k, n, "small", 1)["grids"] + _plan(m, k, n, "gemm", 1)["grids"]) > _GRID_MAX:
        raise ValueError(f"M={m}, N={n}: more than {_GRID_MAX} blocks")
    if m * _cdiv(k, _K_ALIGN) * _K_ALIGN // 4 > _GRID_MAX:
        raise ValueError(f"M={m}, K={k}: more than {_GRID_MAX} units of 4 codes")


def _operands(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor):
    """Raise on what the kernels of ``csrc/int_matmul.cu`` do not take;
    returns M, K, N and the (N,) f32 column scales."""
    m, k = x.shape
    n = w_q.shape[1]
    dev = x.device
    ws = torch.broadcast_to(w_scale.to(torch.float32), (n,)).contiguous()
    _build.check_operand("x", x, torch.float32, dev)
    _build.check_operand("w_q", w_q, torch.int8, dev, align=1)
    _build.check_operand("w_scale", ws, torch.float32, dev, shape=(n,))
    check_limits(m, k, n)
    return m, k, n, ws


def _small_call(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, quant=None,
                lib=None) -> torch.Tensor:
    """Launch the small regime on the card: K1 with ``quant`` = (s_x, zp
    (f32 0-dim tensors on the card), qmin, qmax), K2 with ``quant`` None;
    ``lib`` defaults to this checkout's build. Raises on what the kernel
    does not take. Counts no launch: the public wrappers do."""
    m, k, n, ws = _operands(x, w_q, w_scale)
    lib = lib or _build.load("int_matmul", _LIB_SIGNATURES)
    out = x.new_empty((m, n))
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if quant is None:
        rc = lib.mn_binary_act_matmul_small(x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                                            out.data_ptr(), m, k, n, stream)
    else:
        s_x, zp, qmin, qmax = quant
        rc = lib.mn_int8_matmul_dequant_small(x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                                              s_x.data_ptr(), zp.data_ptr(), out.data_ptr(),
                                              m, k, n, qmin, qmax, stream)
    _build.check(rc, "int_matmul small regime")
    return out


def _gemm_call(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, quant=None,
               lib=None) -> torch.Tensor:
    """Launch the GEMM regime on the card, as :func:`_small_call`: the codes
    and weight pre-passes into scratch allocated here (codes (M, Kp), wT
    (N, Kp), K1's colsum (N,) int32), then the wgmma GEMM."""
    m, k, n, ws = _operands(x, w_q, w_scale)
    lib = lib or _build.load("int_matmul", _LIB_SIGNATURES)
    plan = _plan(m, k, n, "gemm", _build.sm_count(x.device))
    codes = x.new_empty(plan["codes"], dtype=torch.int8)
    wt = x.new_empty(plan["wt"], dtype=torch.int8)
    out = x.new_empty((m, n))
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if quant is None:
        rc = lib.mn_binary_act_matmul_gemm(x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                                           out.data_ptr(), codes.data_ptr(), wt.data_ptr(),
                                           m, k, n, stream)
    else:
        s_x, zp, qmin, qmax = quant
        colsum = x.new_empty((n,), dtype=torch.int32)
        rc = lib.mn_int8_matmul_dequant_gemm(x.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                                             s_x.data_ptr(), zp.data_ptr(), out.data_ptr(),
                                             codes.data_ptr(), wt.data_ptr(), colsum.data_ptr(),
                                             m, k, n, qmin, qmax, stream)
    _build.check(rc, "int_matmul GEMM regime")
    return out


def _card_call(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, quant):
    """The regime :func:`_k1_regime` picks, on the card (the library built
    first, before anything asks the card)."""
    lib = _build.load("int_matmul", _LIB_SIGNATURES)
    regime = _k1_regime(x.shape[0], x.shape[1], w_q.shape[1], _build.sm_count(x.device))
    call = _gemm_call if regime == "gemm" else _small_call
    return call(x, w_q, w_scale, quant, lib)


def _k1_op(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: torch.Tensor,
           x_zero_point: torch.Tensor, qmin: float, qmax: float) -> torch.Tensor:
    """The operator's implementation: the kernel on a CUDA tensor (counted
    on :func:`int8_matmul_dequant`), the twin on a CPU tensor."""
    if not on_cuda(x):
        return int8_matmul_dequant_ref(x, w_q, w_scale, x_scale, x_zero_point, qmin, qmax)
    out = _card_call(x, w_q, w_scale, (x_scale, x_zero_point, qmin, qmax))
    int8_matmul_dequant.launches += 1
    return out


def _k2_op(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """The operator's implementation: the kernel on a CUDA tensor (counted
    on :func:`binary_act_matmul`), the twin on a CPU tensor."""
    if not on_cuda(x):
        return binary_act_matmul_ref(x, w_q, w_scale)
    out = _card_call(x, w_q, w_scale, None)
    binary_act_matmul.launches += 1
    return out


def _out_like(x: torch.Tensor, w_q: torch.Tensor, *_) -> torch.Tensor:
    """Both operators' fake implementation: the (M, N) f32 output."""
    return x.new_empty((x.shape[0], w_q.shape[1]), dtype=torch.float32)


# torch.ops.micronet_tpu_torch: one implementation for every device (the
# kernel or the twin, by the tensor's device) and a fake one for tracing.
# A plain library definition: torch.library.custom_op checks its inputs'
# aliasing on every call, 0.014 to 0.031 ms more host time a call than the
# launch alone on an H100 (chip_smoke.py phase 19), against the kernel's
# 0.007 ms of device time
_LIB = torch.library.Library("micronet_tpu_torch", "DEF")
_LIB.define("int8_matmul_dequant(Tensor x, Tensor w_q, Tensor w_scale, Tensor x_scale, "
            "Tensor x_zero_point, float qmin, float qmax) -> Tensor")
_LIB.define("binary_act_matmul(Tensor x, Tensor w_q, Tensor w_scale) -> Tensor")
_LIB.impl("int8_matmul_dequant", _k1_op, "CompositeExplicitAutograd")
_LIB.impl("binary_act_matmul", _k2_op, "CompositeExplicitAutograd")
torch.library.register_fake("micronet_tpu_torch::int8_matmul_dequant", _out_like, lib=_LIB)
torch.library.register_fake("micronet_tpu_torch::binary_act_matmul", _out_like, lib=_LIB)
_K1_OP = torch.ops.micronet_tpu_torch.int8_matmul_dequant.default
_K2_OP = torch.ops.micronet_tpu_torch.binary_act_matmul.default


def _check_inner(x: torch.Tensor, w_q: torch.Tensor) -> None:
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)}")


def int8_matmul_dequant(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        x_scale: Scalar, x_zero_point: Scalar, qmin: float = -128.0,
                        qmax: float = 127.0) -> torch.Tensor:
    """x (M, K) f32, w_q (K, N) int8, w_scale (N,) or scalar, per-tensor
    activation scale and zero point -> (M, N) f32, through the operator
    ``torch.ops.micronet_tpu_torch.int8_matmul_dequant``. On a CUDA tensor
    this launches the kernel of the regime :func:`_k1_regime` picks or
    raises; on a CPU tensor it runs the twin
    :func:`int8_matmul_dequant_ref`. Give the scale and zero point as 0-dim
    tensors on the card (as the engine does) where the call is captured in
    a CUDA graph: a Python number is copied from the host."""
    _check_inner(x, w_q)
    return _K1_OP(x, w_q, w_scale, _scalar(x_scale, x.device), _scalar(x_zero_point, x.device),
                  float(qmin), float(qmax))


int8_matmul_dequant.launches = 0


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                x_scale: Scalar, x_zero_point: Scalar, bias: Optional[torch.Tensor] = None,
                qmin: float = -128.0, qmax: float = 127.0) -> torch.Tensor:
    """Int8 linear over any leading dims: :func:`int8_matmul_dequant`,
    then the bias (added outside the kernel, as in the JAX package).
    ``qmin``/``qmax`` are the activation quantizer's own range."""
    lead, k = x.shape[:-1], x.shape[-1]
    out = int8_matmul_dequant(x.reshape(-1, k).to(torch.float32).contiguous(), w_q, w_scale,
                              x_scale, x_zero_point, qmin, qmax)
    if bias is not None:
        out = out + bias
    return out.reshape(*lead, w_q.shape[1])


def binary_act_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K2, what the JAX package's XLA route computes.
    The integer product runs in f64, exact for every int32 accumulator."""
    q = torch.where(x >= 0, 1.0, -1.0).to(torch.float64)
    acc = (q @ w_q.to(torch.float64)).to(torch.int32)
    w_scale = torch.broadcast_to(w_scale.to(torch.float32), (w_q.shape[1],))
    return acc.to(torch.float32) * w_scale[None, :]


def binary_act_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 (pre-activation values; the sign is taken inside),
    w_q (K, N) int8 in {-1, 0, +1}, w_scale (N,) or scalar alpha ->
    (M, N) f32, through the operator
    ``torch.ops.micronet_tpu_torch.binary_act_matmul``. On a CUDA tensor
    this launches the kernel of the regime :func:`_k1_regime` picks or
    raises; on a CPU tensor it runs the twin :func:`binary_act_matmul_ref`."""
    _check_inner(x, w_q)
    return _K2_OP(x, w_q, w_scale)


binary_act_matmul.launches = 0
