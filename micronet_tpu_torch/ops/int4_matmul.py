"""Weight-only int4 matmul (W4A16) over hl8-packed group-scaled weights.

Counterpart of ``micronet_tpu/ops/int4_matmul.py``. Only the serving
format is ported here: group scales (K/g, N) and the hl8 byte layout. The
per-column and v1-grouped kernels of the JAX package are not on the
serving path.

Packing: rows [0, K/2) of the (K, N) int4 codes live in the LOW nibble
and rows [K/2, K) in the HIGH nibble of a (K/2, N) int8 array. The hl8
layout XORs every byte with 0x08, so that the byte's signed value is
``b = 16 * q_hi + (q_lo + 8)``; integer unpack is then
``q_hi = b >> 4`` (arithmetic) and ``q_lo = (b & 0xF) - 8``.

Numeric traps kept out of this module:

- rounding is half away from zero, ``sign(x) * floor(|x| + 0.5)``, never
  ``torch.round`` (which rounds half to even);
- torch's bf16 ``matmul`` returns bf16, so the twin multiplies
  bf16-*rounded* operands held in f32 and accumulates in f32, which is
  what JAX's ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._device import on_cuda
from . import _build

__all__ = [
    "symmetric_rtn",
    "symmetric_rtn_grouped",
    "quantize_int4_weight",
    "quantize_int4_weight_grouped",
    "pack_int4",
    "unpack_int4",
    "pack_int4_hl8",
    "unpack_int4_hl8",
    "expand_gscale",
    "int4_matmul_grouped_hl8",
    "int4_matmul_grouped_hl8_ref",
    "wo_linear_grouped_hl8",
]


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``sign(x) * floor(|x| + 0.5)``: the JAX package's rounding."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def symmetric_rtn(
    w: torch.Tensor, qmax: float, axis: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric round-to-nearest: scale = max|w| / qmax over ``axis``,
    round-half-away codes in [-qmax, qmax]. Returns (int8 codes, f32
    scale with ``axis`` kept)."""
    absmax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = torch.clamp(absmax / qmax, min=1e-8).to(torch.float32)
    q = round_half_away(w / scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int8), scale


def symmetric_rtn_grouped(
    w: torch.Tensor, qmax: float, group: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise :func:`symmetric_rtn` over the contraction axis: codes
    (K, N), scales (K/group, N)."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"group {group} does not divide K={k}")
    q, scale = symmetric_rtn(w.reshape(k // group, group, n), qmax, axis=1)
    return q.reshape(k, n), scale.reshape(k // group, n)


def quantize_int4_weight(
    w: torch.Tensor, axis: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column int4: codes in [-7, 7] (K, N), scale (1, N)."""
    return symmetric_rtn(w, 7.0, axis)


def quantize_int4_weight_grouped(
    w: torch.Tensor, group: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise int4: codes (K, N) in [-7, 7], scales (K/group, N)."""
    return symmetric_rtn_grouped(w, 7.0, group)


def _to_int8(u: torch.Tensor) -> torch.Tensor:
    """Byte values 0..255 (any integer dtype) -> the int8 with those bits."""
    u = u.to(torch.int32)
    return torch.where(u >= 128, u - 256, u).to(torch.int8)


def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """(K, N) int codes in [-8, 7] -> (K/2, N) int8: rows < K/2 in the
    low nibble, the rest in the high nibble. K must be even."""
    k = w_q.shape[0]
    if k % 2:
        raise ValueError("K must be even for int4 packing")
    w = w_q.to(torch.int32)
    low = w[: k // 2] & 0xF
    high = (w[k // 2 :] & 0xF) << 4
    return _to_int8(low | high)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (K/2, N) int8 -> (K, N) int8."""
    u = packed.to(torch.int32) & 0xFF
    ulow = u & 0xF
    uhigh = u >> 4
    low = torch.where(ulow >= 8, ulow - 16, ulow)
    high = torch.where(uhigh >= 8, uhigh - 16, uhigh)
    return torch.cat([low, high], dim=0).to(torch.int8)


def pack_int4_hl8(w_q: torch.Tensor) -> torch.Tensor:
    """(K, N) int4 codes -> (K/2, N) int8 in the hl8 byte layout."""
    return _to_int8((pack_int4(w_q).to(torch.int32) & 0xFF) ^ 0x08)


def _hl8_nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed (low-half, high-half) codes of hl8 bytes, as int32."""
    b = packed.to(torch.int32)
    return (b & 0xF) - 8, b >> 4  # >> on int32 is arithmetic


def unpack_int4_hl8(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_hl8`: (K/2, N) int8 -> (K, N) int8."""
    lo, hi = _hl8_nibbles(packed)
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def expand_gscale(gscale: torch.Tensor, group: int) -> torch.Tensor:
    """(K/g, N) -> (K, N), each scale row repeated ``group`` times."""
    return torch.repeat_interleave(gscale, group, dim=0)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Values rounded to bf16 (nearest even) and held in f32, so a product
    of two of them is exact in f32: the twins' stand-in for a bf16
    operand with f32 accumulation (torch's bf16 matmul returns bf16)."""
    return x.to(torch.bfloat16).to(torch.float32)


def int4_matmul_grouped_hl8_ref(
    x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, what the JAX oracle
    ``int4_matmul_grouped_hl8_xla`` computes:

        out[m, n] = sum_g  gscale[g, n] * sum_{k in g} bf16(x[m, k]) * q[k, n]

    Each per-group partial dot multiplies bf16-rounded x by the exact
    codes in f32 (every product is exact), then scales. Matches the
    oracle up to f32 summation order (the oracle's three-dot identity
    only reorders exact products)."""
    k2, n = packed.shape
    groups = gscale.shape[0]
    group = 2 * k2 // groups
    xb = round_bf16(x.reshape(-1, x.shape[-1]).to(torch.float32))
    m = xb.shape[0]
    lo, hi = _hl8_nibbles(packed)
    w = torch.cat([lo, hi], dim=0).to(torch.float32)  # (K, N), exact codes
    parts = torch.bmm(
        xb.reshape(m, groups, group).transpose(0, 1),  # (G, M, g)
        w.reshape(groups, group, n),  # (G, g, N)
    )  # (G, M, N) per-group partial dots, f32
    return (parts * gscale.to(torch.float32)[:, None, :]).sum(dim=0)


_LIB_SIGNATURES = {
    "mn_int4_matmul_grouped_hl8": [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}
_BLOCK_N = 512  # columns per block in csrc/int4_matmul.cu (kBlockN)
_MAX_GROUP = 256  # csrc/int4_matmul.cu kMaxGroup


def _k_splits(g1: int, n: int, device: torch.device) -> int:
    """K-split count, chosen from K, N and the card only (never from M),
    so a row's result does not depend on the batch it shares: enough
    blocks to give every SM two, at most one split per packed group."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    col_blocks = -(-n // _BLOCK_N)
    return max(1, min(g1, -(-2 * sms // col_blocks)))


def int4_matmul_grouped_hl8(
    x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor
) -> torch.Tensor:
    """x (M, K) f32 @ hl8-packed int4 w (K/2, N) with (K/g, N) group
    scales -> (M, N) f32.

    On a CUDA tensor this launches the hand-written kernel
    (``csrc/int4_matmul.cu``) or raises; on a CPU tensor it runs the
    plain twin :func:`int4_matmul_grouped_hl8_ref`. The group must divide
    K/2, so that each nibble half covers whole groups."""
    m, k = x.shape
    k2, n = packed.shape
    groups = gscale.shape[0]
    if k != 2 * k2 or k % groups or gscale.shape[1] != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, gscale {tuple(gscale.shape)}")
    group = k // groups
    if k2 % group:
        raise ValueError(f"group {group} must divide K/2={k2}")
    if not on_cuda(x):
        return int4_matmul_grouped_hl8_ref(x, packed, gscale)
    dev = x.device
    _build.check_operand("x", x, torch.float32, dev)
    _build.check_operand("packed", packed, torch.int8, dev)
    _build.check_operand("gscale", gscale, torch.float32, dev, align=16)
    if n % 4 or group > _MAX_GROUP or m == 0:
        raise ValueError(f"kernel needs N % 4 == 0, group <= {_MAX_GROUP}, "
                         f"M > 0 (N={n}, group={group}, M={m})")
    splits = _k_splits(k2 // group, n, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else out)
    lib = _build.load("int4_matmul", _LIB_SIGNATURES)
    rc = lib.mn_int4_matmul_grouped_hl8(
        x.data_ptr(), packed.data_ptr(), gscale.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, k, n, group, splits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "int4_matmul_grouped_hl8")
    int4_matmul_grouped_hl8.launches += 1
    return out


int4_matmul_grouped_hl8.launches = 0


def wo_linear_grouped_hl8(
    x: torch.Tensor, packed_hl8: torch.Tensor, gscale: torch.Tensor
) -> torch.Tensor:
    """hl8 group-scaled weight-only int4 linear over any leading dims."""
    lead = x.shape[:-1]
    out = int4_matmul_grouped_hl8(
        x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous(),
        packed_hl8, gscale,
    )
    return out.reshape(*lead, packed_hl8.shape[1])
