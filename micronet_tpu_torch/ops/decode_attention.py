"""Fused decode attention over the int8 KV cache.

Counterpart of ``micronet_tpu/ops/decode_attention.py``:
``decode_attend_q8kv`` (cache only), ``decode_attend_q8kv_cur`` (cache
plus the current token's quantized K/V row, the deferred-append serving
path) and their S-blocked forms ``decode_attend_q8kv_blocked(_cur)``. All
run hand-written CUDA kernels (``csrc/decode_attention.cu`` over the
bodies of ``csrc/decode_attention.cuh``) in two regimes:

- one block per KV group, the group's logits in shared memory, for
  S <= 4096 (``decode_attend_q8kv(_cur)``, K5a / K4a);
- split S, for S > 4096, where ``decode_attend_q8kv(_cur)`` hand over
  to ``decode_attend_q8kv_blocked(_cur)`` (K5b / K4b), as the JAX package
  does past ``_MAX_RESIDENT_S``. The dispatch depends on S only. The
  split kernel cuts S into splits of ``_SPLIT`` positions of its own
  choosing; ``block_s`` is accepted for the JAX package's signature and
  does not change the result.

Numerics (the JAX oracles' rounding points), in both regimes:

- logits are bf16(q) times the exact int8 codes, accumulated in f32,
  then times ``k_scale`` and divided by sqrt(D);
- positions >= bound are -inf and p is forced to 0 there;
- p = exp(logit - global max); ``p * v_scale`` is rounded to bf16 and
  multiplied by the codes with f32 accumulation;
- the current column is rounded the same way as a cached one;
- the denominator is floored at 1e-30.

The JAX package's blocked kernels round p against a running max (an
online softmax); the split kernels here keep the global max, so the
blocked wrappers share the plain twins of the whole-cache ones.

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
    "decode_attend_q8kv_blocked",
    "decode_attend_q8kv_blocked_ref",
    "decode_attend_q8kv_blocked_cur",
    "decode_attend_q8kv_blocked_cur_ref",
]

_LIB_SIGNATURES = {
    "mn_decode_attend_q8kv": [ctypes.c_void_p] * 12 + [ctypes.c_longlong]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}
_WARPS, _MAX_D, _MAX_R = 8, 128, 8  # csrc/decode_attention.cuh
_SPLIT = 512  # positions per split of the split-S kernels (kSplit)
_HOPPER_SMEM_OPTIN = 232448  # bytes of shared memory one block may use
# past this S the whole-cache wrappers run the split-S kernels (the JAX
# package's threshold for its S-blocked kernels)
_MAX_RESIDENT_S = 4096


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


# The split-S kernels keep the global-max rounding of the whole-cache
# kernels, so they share their plain twins.
decode_attend_q8kv_blocked_ref = decode_attend_q8kv_ref
decode_attend_q8kv_blocked_cur_ref = decode_attend_q8kv_cur_ref


def _smem_bytes(r: int, s: int) -> int:
    return 4 * (_WARPS * r * _MAX_D + r * (s + 1))


def split_scratch_floats(g: int, s: int, d: int, r: int) -> int:
    """Floats of scratch the split-S kernels need: the (G, R, S + 1)
    logits and, per split, each row's max, denominator and D partial
    sums (``csrc/decode_attention.cuh::split_scratch_floats``)."""
    return g * r * (s + 1 + -(-s // _SPLIT) * (d + 2))


def check_limits(s: int, d: int, r: int, split: bool) -> None:
    """Raise unless the kernels take this geometry: D % 4 == 0, D <= 128,
    R <= 8 and, for the one-block regime, S small enough for the group's
    logits to fit in shared memory."""
    if d % 4 or d > _MAX_D or r > _MAX_R or (
            not split and _smem_bytes(r, s) > _HOPPER_SMEM_OPTIN):
        raise ValueError(f"kernel needs D % 4 == 0, D <= {_MAX_D}, R <= {_MAX_R} "
                         f"and, in one block, S small enough for shared memory "
                         f"(D={d}, R={r}, S={s})")


def cur_operands(cur, lead):
    """The operand checks of the current rows ``cur`` (k, k_scale, v,
    v_scale) for a kernel whose groups have shape ``lead``."""
    k, ks, v, vs = cur
    d = k.shape[-1]
    return [("k_cur", k, torch.int8, lead + (d,)), ("k_cur_scale", ks, torch.float32, lead),
            ("v_cur", v, torch.int8, lead + (d,)), ("v_cur_scale", vs, torch.float32, lead)]


def _launch(k_codes, k_scale, v_codes, v_scale, q, bound, cur, split):
    """Check operands and launch a kernel; ``cur`` is None or the four
    current-row tensors. Returns the (G, R, D) output."""
    g, s, d = k_codes.shape
    q3 = q if q.dim() == 3 else q[:, None, :]
    r = q3.shape[1]
    check_limits(s, d, r, split)
    dev = k_codes.device
    want = [
        ("k_codes", k_codes, torch.int8, (g, s, d)),
        ("k_scale", k_scale, torch.float32, (g, s)),
        ("v_codes", v_codes, torch.int8, (g, s, d)),
        ("v_scale", v_scale, torch.float32, (g, s)),
        ("q", q3, torch.float32, (g, r, d)),
        ("bound", bound, torch.int32, (g,)),
    ] + ([] if cur is None else cur_operands(cur, (g,)))
    for name, t, dtype, shape in want:
        _build.check_operand(name, t, dtype, dev, shape)
    out = torch.empty((g, r, d), dtype=torch.float32, device=dev)
    n_scratch = split_scratch_floats(g, s, d, r) if split else 0
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev) if split else None
    ptrs = [0, 0, 0, 0] if cur is None else [t.data_ptr() for t in cur]
    lib = _build.load("decode_attention", _LIB_SIGNATURES)
    rc = lib.mn_decode_attend_q8kv(
        k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
        v_scale.data_ptr(), q3.data_ptr(), bound.data_ptr(), *ptrs,
        out.data_ptr(), scratch.data_ptr() if split else 0, n_scratch,
        g, s, d, r, int(cur is not None), int(split),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "decode_attend_q8kv" + ("_blocked" if split else "")
                 + ("_cur" if cur is not None else ""))
    return out if q.dim() == 3 else out[:, 0, :]


def decode_attend_q8kv(k_codes, k_scale, v_codes, v_scale, q, bound):
    """Single-token attention against an int8 KV cache.

    k_codes/v_codes (G, S, D) int8, k_scale/v_scale (G, S) f32, q (G, D)
    or (G, R, D) f32 with R <= 8 (GQA: R query heads share KV group g),
    bound (G,) int32: positions < bound are visible. Returns (G, D) or
    (G, R, D) f32. For S > 4096 this is :func:`decode_attend_q8kv_blocked`.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`decode_attend_q8kv_ref`."""
    if k_codes.shape[1] > _MAX_RESIDENT_S:
        return decode_attend_q8kv_blocked(k_codes, k_scale, v_codes, v_scale, q, bound)
    if not on_cuda(k_codes):
        return decode_attend_q8kv_ref(k_codes, k_scale, v_codes, v_scale, q, bound)
    out = _launch(k_codes, k_scale, v_codes, v_scale, q, bound, None, split=False)
    decode_attend_q8kv.launches += 1
    return out


decode_attend_q8kv.launches = 0


def decode_attend_q8kv_cur(
    k_codes, k_scale, v_codes, v_scale, q, bound,
    k_cur, k_cur_scale, v_cur, v_cur_scale,
):
    """Decode attention over cache[< bound] plus the current token's
    quantized K/V row (k_cur/v_cur (G, D) int8, scales (G,) f32) as one
    more always-visible column. The caller appends the same codes to
    the cache afterwards. For S > 4096 this is
    :func:`decode_attend_q8kv_blocked_cur`. Same contract as
    :func:`decode_attend_q8kv` otherwise."""
    args = (k_codes, k_scale, v_codes, v_scale, q, bound,
            k_cur, k_cur_scale, v_cur, v_cur_scale)
    if k_codes.shape[1] > _MAX_RESIDENT_S:
        return decode_attend_q8kv_blocked_cur(*args)
    if not on_cuda(k_codes):
        return decode_attend_q8kv_cur_ref(*args)
    out = _launch(*args[:6], args[6:], split=False)
    decode_attend_q8kv_cur.launches += 1
    return out


decode_attend_q8kv_cur.launches = 0


def decode_attend_q8kv_blocked(k_codes, k_scale, v_codes, v_scale, q, bound, *,
                               block_s: int = 1024):
    """:func:`decode_attend_q8kv` on the split-S kernel (any S; the
    long-context path past S = 4096). ``block_s`` is the JAX package's
    block size, accepted for its signature: the kernel cuts S into splits
    of its own (``_SPLIT``), and the result does not depend on either.
    CPU tensors run :func:`decode_attend_q8kv_blocked_ref`."""
    if not on_cuda(k_codes):
        return decode_attend_q8kv_blocked_ref(k_codes, k_scale, v_codes, v_scale, q, bound)
    out = _launch(k_codes, k_scale, v_codes, v_scale, q, bound, None, split=True)
    decode_attend_q8kv_blocked.launches += 1
    return out


decode_attend_q8kv_blocked.launches = 0


def decode_attend_q8kv_blocked_cur(
    k_codes, k_scale, v_codes, v_scale, q, bound,
    k_cur, k_cur_scale, v_cur, v_cur_scale, *, block_s: int = 1024,
):
    """:func:`decode_attend_q8kv_cur` on the split-S kernel; ``block_s``
    as in :func:`decode_attend_q8kv_blocked`. At bound b it equals
    :func:`decode_attend_q8kv_blocked` at b + 1 over a cache whose row b
    holds the current row, bit for bit on the card."""
    args = (k_codes, k_scale, v_codes, v_scale, q, bound,
            k_cur, k_cur_scale, v_cur, v_cur_scale)
    if not on_cuda(k_codes):
        return decode_attend_q8kv_blocked_cur_ref(*args)
    out = _launch(*args[:6], args[6:], split=True)
    decode_attend_q8kv_blocked_cur.launches += 1
    return out


decode_attend_q8kv_blocked_cur.launches = 0
