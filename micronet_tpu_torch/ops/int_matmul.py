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

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/int_matmul.cu``) or raises; on a CPU tensor it runs its plain
twin (``*_ref``), which does the same f32 operations in the same order,
so kernel and twin agree bit for bit. K2 masks the ragged K edge with
code 0 inside the kernel: padding x with zeros would binarize them to +1.
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
    "mn_int8_matmul_dequant": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "mn_binary_act_matmul": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def int8_matmul_dequant(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        x_scale: Scalar, x_zero_point: Scalar, qmin: float = -128.0,
                        qmax: float = 127.0) -> torch.Tensor:
    """x (M, K) f32, w_q (K, N) int8, w_scale (N,) or scalar, per-tensor
    activation scale and zero point -> (M, N) f32. Ragged M, N and K are
    masked inside the kernel; nothing is padded."""
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)}")
    if not on_cuda(x):
        return int8_matmul_dequant_ref(x, w_q, w_scale, x_scale, x_zero_point, qmin, qmax)
    dev = x.device
    s_x = _scalar(x_scale, dev)
    zp = _scalar(x_zero_point, dev)
    ws = torch.broadcast_to(w_scale.to(torch.float32), (n,)).contiguous()
    _build.check_operand("x", x, torch.float32, dev)
    _build.check_operand("w_q", w_q, torch.int8, dev, align=1)
    _build.check_operand("w_scale", ws, torch.float32, dev, shape=(n,))
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"kernel needs M, K, N > 0 (M={m}, K={k}, N={n})")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _build.load("int_matmul", _LIB_SIGNATURES)
    rc = lib.mn_int8_matmul_dequant(
        x.data_ptr(), w_q.data_ptr(), ws.data_ptr(), s_x.data_ptr(), zp.data_ptr(),
        out.data_ptr(), m, k, n, float(qmin), float(qmax),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "int8_matmul_dequant")
    int8_matmul_dequant.launches += 1
    return out


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
    (M, N) f32. Ragged M, N and K are masked inside the kernel; nothing
    is padded."""
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"shapes x {tuple(x.shape)}, w_q {tuple(w_q.shape)}")
    if not on_cuda(x):
        return binary_act_matmul_ref(x, w_q, w_scale)
    dev = x.device
    ws = torch.broadcast_to(w_scale.to(torch.float32), (n,)).contiguous()
    _build.check_operand("x", x, torch.float32, dev)
    _build.check_operand("w_q", w_q, torch.int8, dev, align=1)
    _build.check_operand("w_scale", ws, torch.float32, dev, shape=(n,))
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"kernel needs M, K, N > 0 (M={m}, K={k}, N={n})")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _build.load("int_matmul", _LIB_SIGNATURES)
    rc = lib.mn_binary_act_matmul(x.data_ptr(), w_q.data_ptr(), ws.data_ptr(), out.data_ptr(),
                                  m, k, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "binary_act_matmul")
    binary_act_matmul.launches += 1
    return out


binary_act_matmul.launches = 0
