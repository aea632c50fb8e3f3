"""Fused decode attention over the int8 KV cache.

Counterpart of ``micronet_tpu/ops/decode_attention.py``'s whole-cache
kernels: ``decode_attend_q8kv`` (cache only) and
``decode_attend_q8kv_cur`` (cache plus the current token's quantized K/V
row, the deferred-append serving path). Both run one hand-written CUDA
kernel, ``csrc/decode_attention.cu``, instantiated with and without the
current column. The S-blocked online-softmax variants of the JAX package
are not ported yet: the kernel here holds a group's logits in shared
memory, which covers S up to about 14k at R = 4.

Numerics (the JAX oracles' rounding points):

- logits are bf16(q) times the exact int8 codes, accumulated in f32,
  then times ``k_scale`` and divided by sqrt(D);
- positions >= bound are -inf and p is forced to 0 there;
- p = exp(logit - global max); ``p * v_scale`` is rounded to bf16 and
  multiplied by the codes with f32 accumulation;
- the current column is rounded the same way as a cached one;
- the denominator is floored at 1e-30.

torch's bf16 ``matmul`` returns bf16, so the twins hold bf16-rounded
values in f32 (:func:`..ops.int4_matmul.round_bf16`) and multiply in f32
(every product is exact).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._device import on_cuda
from . import _build
from .int4_matmul import round_bf16

__all__ = [
    "decode_attend_q8kv",
    "decode_attend_q8kv_ref",
    "decode_attend_q8kv_cur",
    "decode_attend_q8kv_cur_ref",
]

_LIB_SIGNATURES = {
    "mn_decode_attend_q8kv": [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}
_WARPS, _MAX_D, _MAX_R = 8, 128, 8  # csrc/decode_attention.cu
_HOPPER_SMEM_OPTIN = 232448  # bytes of shared memory one block may use


def _logits(k_codes, k_scale, q_rows, bound):
    """Masked logits (G, R, S) and the validity mask."""
    g, s, d = k_codes.shape
    logits = torch.einsum("grd,gsd->grs", round_bf16(q_rows), k_codes.to(torch.float32))
    logits = logits * k_scale[:, None, :] / math.sqrt(d)
    valid = torch.arange(s, device=k_codes.device)[None, None, :] < bound[:, None, None]
    return torch.where(valid, logits, -math.inf), valid


def decode_attend_q8kv_ref(k_codes, k_scale, v_codes, v_scale, q, bound):
    """Plain twin of :func:`decode_attend_q8kv` (the JAX oracle
    ``decode_attend_q8kv_xla``)."""
    gqa = q.dim() == 3
    q_rows = q if gqa else q[:, None, :]
    logits, valid = _logits(k_codes, k_scale, q_rows, bound)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = round_bf16(p * v_scale[:, None, :])
    acc = torch.einsum("grs,gsd->grd", pv, v_codes.to(torch.float32))
    out = acc / denom
    return out if gqa else out[:, 0, :]


def decode_attend_q8kv_cur_ref(
    k_codes, k_scale, v_codes, v_scale, q, bound,
    k_cur, k_cur_scale, v_cur, v_cur_scale,
):
    """Plain twin of :func:`decode_attend_q8kv_cur` (the JAX oracle
    ``decode_attend_q8kv_cur_xla``): one extra, always visible column."""
    d = k_codes.shape[-1]
    gqa = q.dim() == 3
    q_rows = q if gqa else q[:, None, :]
    logits, valid = _logits(k_codes, k_scale, q_rows, bound)
    lcur = torch.einsum("grd,gd->gr", round_bf16(q_rows), k_cur.to(torch.float32))
    lcur = lcur * k_cur_scale[:, None] / math.sqrt(d)  # (G, R)
    m = torch.maximum(torch.amax(logits, dim=-1), lcur)[..., None]
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    pcur = torch.exp(lcur[..., None] - m)  # (G, R, 1)
    denom = p.sum(dim=-1, keepdim=True) + pcur
    pv = round_bf16(p * v_scale[:, None, :])
    acc = torch.einsum("grs,gsd->grd", pv, v_codes.to(torch.float32))
    pvcur = round_bf16(pcur * v_cur_scale[:, None, None])
    acc = acc + pvcur * v_cur.to(torch.float32)[:, None, :]
    out = acc / torch.clamp(denom, min=1e-30)
    return out if gqa else out[:, 0, :]


def _smem_bytes(r: int, s: int) -> int:
    return 4 * (_WARPS * r * _MAX_D + r * (s + 1))


def _launch(k_codes, k_scale, v_codes, v_scale, q, bound, cur):
    """Check operands and launch the kernel; ``cur`` is None or the four
    current-row tensors. Returns the (G, R, D) output."""
    g, s, d = k_codes.shape
    q3 = q if q.dim() == 3 else q[:, None, :]
    r = q3.shape[1]
    if d % 4 or d > _MAX_D or r > _MAX_R or _smem_bytes(r, s) > _HOPPER_SMEM_OPTIN:
        raise ValueError(f"kernel needs D % 4 == 0, D <= {_MAX_D}, R <= {_MAX_R} "
                         f"and S small enough for shared memory (D={d}, R={r}, S={s})")
    dev = k_codes.device
    want = [
        ("k_codes", k_codes, torch.int8, (g, s, d)),
        ("k_scale", k_scale, torch.float32, (g, s)),
        ("v_codes", v_codes, torch.int8, (g, s, d)),
        ("v_scale", v_scale, torch.float32, (g, s)),
        ("q", q3, torch.float32, (g, r, d)),
        ("bound", bound, torch.int32, (g,)),
    ]
    if cur is not None:
        want += [
            ("k_cur", cur[0], torch.int8, (g, d)),
            ("k_cur_scale", cur[1], torch.float32, (g,)),
            ("v_cur", cur[2], torch.int8, (g, d)),
            ("v_cur_scale", cur[3], torch.float32, (g,)),
        ]
    for name, t, dtype, shape in want:
        _build.check_operand(name, t, dtype, dev, shape)
    out = torch.empty((g, r, d), dtype=torch.float32, device=dev)
    ptrs = [0, 0, 0, 0] if cur is None else [t.data_ptr() for t in cur]
    lib = _build.load("decode_attention", _LIB_SIGNATURES)
    rc = lib.mn_decode_attend_q8kv(
        k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
        v_scale.data_ptr(), q3.data_ptr(), bound.data_ptr(), *ptrs,
        out.data_ptr(), g, s, d, r, int(cur is not None),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "decode_attend_q8kv" + ("_cur" if cur is not None else ""))
    return out


def decode_attend_q8kv(k_codes, k_scale, v_codes, v_scale, q, bound):
    """Single-token attention against an int8 KV cache.

    k_codes/v_codes (G, S, D) int8, k_scale/v_scale (G, S) f32, q (G, D)
    or (G, R, D) f32 with R <= 8 (GQA: R query heads share KV group g),
    bound (G,) int32: positions < bound are visible. Returns (G, D) or
    (G, R, D) f32. CUDA tensors launch the kernel (or raise); CPU tensors
    run :func:`decode_attend_q8kv_ref`."""
    if not on_cuda(k_codes):
        return decode_attend_q8kv_ref(k_codes, k_scale, v_codes, v_scale, q, bound)
    out = _launch(k_codes, k_scale, v_codes, v_scale, q, bound, None)
    decode_attend_q8kv.launches += 1
    return out if q.dim() == 3 else out[:, 0, :]


decode_attend_q8kv.launches = 0


def decode_attend_q8kv_cur(
    k_codes, k_scale, v_codes, v_scale, q, bound,
    k_cur, k_cur_scale, v_cur, v_cur_scale,
):
    """Decode attention over cache[< bound] plus the current token's
    quantized K/V row (k_cur/v_cur (G, D) int8, scales (G,) f32) as one
    more always-visible column. The caller appends the same codes to
    the cache afterwards. Same contract as :func:`decode_attend_q8kv`
    otherwise."""
    if not on_cuda(k_codes):
        return decode_attend_q8kv_cur_ref(
            k_codes, k_scale, v_codes, v_scale, q, bound,
            k_cur, k_cur_scale, v_cur, v_cur_scale,
        )
    out = _launch(k_codes, k_scale, v_codes, v_scale, q, bound,
                  (k_cur, k_cur_scale, v_cur, v_cur_scale))
    decode_attend_q8kv_cur.launches += 1
    return out if q.dim() == 3 else out[:, 0, :]


decode_attend_q8kv_cur.launches = 0
