"""Weight-only int4 matmuls (W4A16): the counterpart of
``micronet_tpu/ops/int4_matmul.py``, its three kernels each with a plain
twin:

- K3 :func:`int4_matmul_grouped_hl8`, the serving format: group scales
  (K/g, N) over the hl8 byte layout, each group's partial dot scaled; on
  the card in two regimes chosen by :func:`_k3_regime` from M and the
  group (decode: the w4 kernel; prefill: a wgmma GEMM);
- K8 :func:`int4_matmul`: the plain packing with per-column scales,
  applied in the epilogue;
- K9 :func:`int4_matmul_grouped`: the plain packing with group scales,
  each weight dequantized to bf16 (``bf16(f32(q) * gscale)``, rounded
  once) before the dot.

Packing: rows [0, K/2) of the (K, N) int4 codes live in the LOW nibble
and rows [K/2, K) in the HIGH nibble of a (K/2, N) int8 array. The plain
layout (:func:`pack_int4`) unpacks as ``q_lo = (b << 4) >> 4`` and
``q_hi = b >> 4`` (arithmetic). The hl8 layout XORs every byte with 0x08,
so that the byte's signed value is ``b = 16 * q_hi + (q_lo + 8)``;
integer unpack is then ``q_hi = b >> 4`` and ``q_lo = (b & 0xF) - 8``.
A group must divide K/2, so each nibble half covers whole groups.

Numeric traps kept out of this module:

- rounding is half away from zero, ``sign(x) * floor(|x| + 0.5)``, never
  ``torch.round`` (which rounds half to even);
- torch's bf16 ``matmul`` returns bf16, so the twin multiplies
  bf16-*rounded* operands held in f32 and accumulates in f32, which is
  what JAX's ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .._device import on_cuda
from ..quant.rounding import round_half_away
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
    "int4_matmul",
    "int4_matmul_ref",
    "int4_matmul_grouped",
    "int4_matmul_grouped_ref",
    "wo_linear",
    "wo_linear_grouped",
]


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
    "mn_int4_matmul_grouped_hl8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "mn_int4_matmul_grouped_hl8_gemm": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "mn_int4_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "mn_int4_matmul_grouped": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}
# the w4 kernel (csrc/int4_matmul.cu: K8, K9, K3's regime A): kW4BlockN columns a block, K
# split in units of kW4StageRows packed rows
_W4_BLOCK_N = 128
_W4_UNIT = 64
# K3's regimes (csrc/int4_matmul.cu): up to _K3_DECODE_ROWS batch rows, or with a group that is
# not a multiple of 16 rows, the w4 kernel (regime A); past it the wgmma GEMM (regime B), whose
# blocks take _GEMM_ROWS batch rows
_K3_DECODE_ROWS = 128
_GEMM_ROWS = 128


def _k3_regime(m: int, group: int) -> str:
    """K3's regime from the batch rows and the group alone (never x, N or
    the card): "A" (decode, the w4 kernel) for M <= 128 or a group that is
    not a multiple of 16 rows, else "B" (prefill, the wgmma GEMM). A row's
    result is the same bits whatever shares its call within a regime; across
    the boundary it agrees within the tolerance only."""
    return "A" if m <= _K3_DECODE_ROWS or group % 16 else "B"


def int4_matmul_grouped_hl8(
    x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor
) -> torch.Tensor:
    """x (M, K) f32 @ hl8-packed int4 w (K/2, N) with (K/g, N) group
    scales -> (M, N) f32.

    On a CUDA tensor this launches the hand-written kernel of the regime
    :func:`_k3_regime` picks (``csrc/int4_matmul.cu``) or raises; on a CPU
    tensor it runs the plain twin :func:`int4_matmul_grouped_hl8_ref`. The
    group must divide K/2, so that each nibble half covers whole groups."""
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
    if _k3_regime(m, group) == "A":
        out = _plain_call("mn_int4_matmul_grouped_hl8", x, packed, gscale, group)
    else:
        out = _gemm_call(x, packed, gscale, group)
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


# ---------------------------------------------------------------------------
# K8 and K9: the plain packing (pack_int4), per-column and group scales
# ---------------------------------------------------------------------------


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K8, what the JAX oracle ``int4_matmul_xla``
    computes: bf16-rounded x times the exact codes, f32 sums, then the
    per-column scale."""
    w = unpack_int4(packed).to(torch.float32)
    out = round_bf16(x.to(torch.float32)) @ w
    return out * scale.to(torch.float32).reshape(1, -1)


def _dequant_grouped_bf16(packed: torch.Tensor, gscale: torch.Tensor,
                          group: int) -> torch.Tensor:
    """(K, N) weights ``bf16(f32(code) * f32(group scale))``, rounded once
    and held in f32."""
    w = unpack_int4(packed).to(torch.float32)
    return round_bf16(w * expand_gscale(gscale.to(torch.float32), group))


def int4_matmul_grouped_ref(x: torch.Tensor, packed: torch.Tensor,
                            gscale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K9, what the JAX oracle
    ``int4_matmul_grouped_xla`` computes: the weights dequantized to bf16
    first, then the low and the high half as two dots with exact products
    and f32 sums, added."""
    k2 = packed.shape[0]
    w = _dequant_grouped_bf16(packed, gscale, 2 * k2 // gscale.shape[0])
    xb = round_bf16(x.to(torch.float32))
    return xb[:, :k2] @ w[:k2] + xb[:, k2:] @ w[k2:]


@functools.lru_cache(maxsize=None)
def _w4_splits(k2: int, n: int, sms: int) -> int:
    """The w4 kernel's K-split count (K8, K9, K3's regime A), from K/2, N
    and the card's SM count only (never from M, so a row's result does not
    depend on the batch it shares): about two blocks of 128 columns per SM,
    at most one split per unit of 64 packed rows."""
    units = -(-k2 // _W4_UNIT)
    return max(1, min(units, 2 * sms // -(-n // _W4_BLOCK_N)))


# Kept per (card, stream), since stream order keeps two calls from sharing them at once:
# - the split calls' int32 tile counters, which the kernel leaves zeroed;
# - the workspace of the split calls of up to _W4_KEEP_ROWS batch rows (decode). Its size is
#   fixed: with splits > 1, _w4_splits gives splits x column tiles <= 2 x SMs, so such a
#   call's (splits, M, N) f32 partials fit in 2 x SMs x 128 x 16 floats (2.2 MB on an H100),
#   whatever K and N. A decode call is host-bound, and an allocation is about a sixth of its
#   host time (tools/w4_variants.py); a larger call, bound by its kernel, allocates its own.
_W4_KEEP_ROWS = 16
_W4_COUNTERS = {}
_W4_WORKSPACE = {}


def _w4_counters(dev: torch.device, stream: int, tiles: int) -> torch.Tensor:
    c = _W4_COUNTERS.get((dev.index, stream))
    if c is None or c.numel() < tiles:
        c = _W4_COUNTERS[dev.index, stream] = torch.zeros(max(tiles, 4096), dtype=torch.int32,
                                                          device=dev)
    return c


def _w4_workspace(dev: torch.device, stream: int, sms: int) -> torch.Tensor:
    ws = _W4_WORKSPACE.get((dev.index, stream))
    if ws is None:
        ws = _W4_WORKSPACE[dev.index, stream] = torch.empty(
            2 * sms * _W4_BLOCK_N * _W4_KEEP_ROWS, dtype=torch.float32, device=dev)
    return ws


def _check_operands(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on what the kernels of ``csrc/int4_matmul.cu`` do not take."""
    m, n = x.shape[0], packed.shape[1]
    dev = x.device
    _build.check_operand("x", x, torch.float32, dev)
    _build.check_operand("packed", packed, torch.int8, dev)
    _build.check_operand("scale", scale, torch.float32, dev, align=16)
    if n % 4 or m == 0:
        raise ValueError(f"kernel needs N % 4 == 0 and M > 0 (N={n}, M={m})")


def _plain_call(fn: str, x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                group: int, lib=None) -> torch.Tensor:
    """Launch the w4 kernel on the card: K8 (``group`` 0), K9 or K3's
    regime A, from ``lib`` (default: this checkout's build of
    ``csrc/int4_matmul.cu``); raises on what the kernel does not take."""
    m, k = x.shape
    n = packed.shape[1]
    dev = x.device
    _check_operands(x, packed, scale)
    # built on first use, before anything asks the card
    launch = getattr(lib or _build.load("int4_matmul", _LIB_SIGNATURES), fn)
    sms = _build.sm_count(dev)
    splits = _w4_splits(k // 2, n, sms)
    mb = 1 if m <= 8 else 2  # batch rows of a block / 8
    out = x.new_empty((m, n))
    # torch.cuda.current_stream(dev).cuda_stream without building a Stream object (cheaper on
    # the host: tools/w4_variants.py times both)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = counters = None
    if splits > 1:
        ws = _w4_workspace(dev, stream, sms) if m <= _W4_KEEP_ROWS else x.new_empty((splits, m, n))
        counters = _w4_counters(dev, stream, -(-m // (8 * mb)) * -(-n // _W4_BLOCK_N))
    args = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, k, n)
    with _build.on_card(dev):
        rc = (launch(*args, group, splits, mb, stream) if group
              else launch(*args, splits, mb, stream))
    _build.check(rc, fn[3:])
    return out


def _gemm_call(x: torch.Tensor, packed: torch.Tensor, gscale: torch.Tensor,
               group: int) -> torch.Tensor:
    """Launch K3's regime B on the card: the bf16 pre-pass of x into a
    scratch of two (Mp, K/2) planes, Mp = M rounded up to ``_GEMM_ROWS``,
    then the wgmma GEMM; raises on what the kernel does not take."""
    m, k = x.shape
    n = packed.shape[1]
    _check_operands(x, packed, gscale)
    launch = _build.load("int4_matmul", _LIB_SIGNATURES).mn_int4_matmul_grouped_hl8_gemm
    mp = -(-m // _GEMM_ROWS) * _GEMM_ROWS
    xb = torch.empty(2 * mp * (k // 2), dtype=torch.bfloat16, device=x.device)
    out = x.new_empty((m, n))
    with _build.on_card(x.device):
        rc = launch(x.data_ptr(), packed.data_ptr(), gscale.data_ptr(), out.data_ptr(),
                    xb.data_ptr(), m, k, n, group,
                    torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check(rc, "int4_matmul_grouped_hl8_gemm")
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K8: x (M, K) f32 @ plain-packed int4 w (K/2, N) * scale (N,) or
    (1, N) -> (M, N) f32. On a CUDA tensor this launches the hand-written
    kernel (``csrc/int4_matmul.cu``) or raises; on a CPU tensor it runs
    the plain twin :func:`int4_matmul_ref`."""
    m, k = x.shape
    k2, n = packed.shape
    if k != 2 * k2 or scale.numel() != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not on_cuda(x):
        return int4_matmul_ref(x, packed, scale)
    if scale.dim() != 1 or not scale.is_contiguous():
        scale = scale.reshape(-1).contiguous()
    out = _plain_call("mn_int4_matmul", x, packed, scale, 0)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def int4_matmul_grouped(x: torch.Tensor, packed: torch.Tensor,
                        gscale: torch.Tensor) -> torch.Tensor:
    """K9: x (M, K) f32 @ plain-packed int4 w (K/2, N) with (K/g, N) group
    scales -> (M, N) f32. The group must divide K/2. On a CUDA tensor this
    launches the hand-written kernel or raises; on a CPU tensor it runs
    the plain twin :func:`int4_matmul_grouped_ref`."""
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
        return int4_matmul_grouped_ref(x, packed, gscale)
    out = _plain_call("mn_int4_matmul_grouped", x, packed, gscale, group)
    int4_matmul_grouped.launches += 1
    return out


int4_matmul_grouped.launches = 0


def wo_linear(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-column weight-only int4 linear (K8) over any leading dims."""
    lead = x.shape[:-1]
    out = int4_matmul(x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous(), packed, scale)
    return out.reshape(*lead, packed.shape[1])


def wo_linear_grouped(x: torch.Tensor, packed: torch.Tensor,
                      gscale: torch.Tensor) -> torch.Tensor:
    """Group-scaled weight-only int4 linear (K9) over any leading dims."""
    lead = x.shape[:-1]
    out = int4_matmul_grouped(x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous(),
                              packed, gscale)
    return out.reshape(*lead, packed.shape[1])
