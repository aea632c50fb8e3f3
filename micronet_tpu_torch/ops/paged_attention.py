"""Paged int8-KV decode attention.

Counterpart of ``micronet_tpu/ops/paged_attention.py``: every slot's
query attends to its KV pages read in place from the shared pool
(:mod:`..quant.paged_kv`) through the page table. ``paged_decode_attend_cur``
(K6) adds the current token's quantized K/V row as one more column (the
paged serving loop's deferred append); ``paged_decode_attend`` (K7) is
the form without it.

Both run the hand-written CUDA kernel ``csrc/paged_attention.cu``: the
bodies of the dense kernels (``csrc/decode_attention.cuh``) with paged
row addressing, in the regime the dense wrappers pick at the same
S = max_pages * page (one cluster of blocks per group up to
``_MAX_CLUSTER_S``, split S beyond).
So a pool gives bit for bit what the dense kernel gives over the view
gathered from it, and the plain twins are that gather followed by the
dense twins (the JAX package's ``paged_decode_attend(_cur)_xla``).
"""

from __future__ import annotations

import ctypes

import torch

from .._device import on_cuda
from . import _build
from .decode_attention import (
    _plan,
    check_limits,
    cur_operands,
    decode_attend_q8kv_cur_ref,
    decode_attend_q8kv_ref,
    split_scratch_floats,
)

__all__ = [
    "paged_decode_attend",
    "paged_decode_attend_ref",
    "paged_decode_attend_cur",
    "paged_decode_attend_cur_ref",
]

_LIB_SIGNATURES = {
    "mn_paged_decode_attend": [ctypes.c_void_p] * 13 + [ctypes.c_longlong]
    + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}


def _gather_dense_batch(codes, scale, page_table):
    """Every slot's logical dense view of the pool: codes (P, H, page, D)
    and scale (P, H, 1, page) gathered by the (slots, MP) table into
    ((slots * H, S, D) codes, (slots * H, S) scales), S = MP * page."""
    slots, mp = page_table.shape
    _, h, page, d = codes.shape
    idx = page_table.to(torch.int64)
    c = codes[idx]  # (slots, MP, H, page, D)
    sc = scale[idx]  # (slots, MP, H, 1, page)
    return (c.permute(0, 2, 1, 3, 4).reshape(slots * h, mp * page, d),
            sc[:, :, :, 0, :].permute(0, 2, 1, 3).reshape(slots * h, mp * page))


def _dense_args(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q):
    kc, ks = _gather_dense_batch(k_codes, k_scale, page_table)
    vc, vs = _gather_dense_batch(v_codes, v_scale, page_table)
    slots, h, r, d = q.shape
    bound = lengths.to(torch.int32)[:, None].expand(slots, h).reshape(slots * h)
    return kc, ks, vc, vs, q.reshape(slots * h, r, d).to(torch.float32), bound


def paged_decode_attend_ref(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q):
    """Plain twin of :func:`paged_decode_attend`: gather, then the dense
    twin."""
    out = decode_attend_q8kv_ref(
        *_dense_args(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q))
    return out.reshape(q.shape)


def paged_decode_attend_cur_ref(
    k_codes, k_scale, v_codes, v_scale, page_table, lengths, q,
    k_cur, k_cur_scale, v_cur, v_cur_scale,
):
    """Plain twin of :func:`paged_decode_attend_cur`: gather, then the
    dense deferred-append twin."""
    slots, h, _, d = q.shape
    g = slots * h
    out = decode_attend_q8kv_cur_ref(
        *_dense_args(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q),
        k_cur.reshape(g, d), k_cur_scale.reshape(g).to(torch.float32),
        v_cur.reshape(g, d), v_cur_scale.reshape(g).to(torch.float32),
    )
    return out.reshape(q.shape)


def _launch(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q, cur):
    p, h, page, d = k_codes.shape
    slots, mp = page_table.shape
    r = q.shape[2]
    s = mp * page
    check_limits(s, d, r)
    dev = k_codes.device
    want = [
        ("k_codes", k_codes, torch.int8, (p, h, page, d)),
        ("k_scale", k_scale, torch.float32, (p, h, 1, page)),
        ("v_codes", v_codes, torch.int8, (p, h, page, d)),
        ("v_scale", v_scale, torch.float32, (p, h, 1, page)),
        ("q", q, torch.float32, (slots, h, r, d)),
        ("page_table", page_table, torch.int32, (slots, mp)),
        ("lengths", lengths, torch.int32, (slots,)),
    ] + ([] if cur is None else cur_operands(cur, (slots, h)))
    for name, t, dtype, shape in want:
        _build.check_operand(name, t, dtype, dev, shape)
    out = torch.empty((slots, h, r, d), dtype=torch.float32, device=dev)
    cluster, lmax = _plan(s)  # the dense wrappers' regime at the same S
    n_scratch = 0 if cluster else split_scratch_floats(slots * h, s, d, r)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev) if n_scratch else None
    ptrs = [0, 0, 0, 0] if cur is None else [t.data_ptr() for t in cur]
    lib = _build.load("paged_attention", _LIB_SIGNATURES)
    rc = lib.mn_paged_decode_attend(
        k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        q.data_ptr(), page_table.data_ptr(), lengths.data_ptr(), *ptrs, out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), n_scratch, slots, h, page, mp, d, r,
        int(cur is not None), cluster, lmax, torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _build.check(rc, "paged_decode_attend" + ("_cur" if cur is not None else ""))
    return out


def paged_decode_attend(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q):
    """Decode attention of every slot against its paged int8 KV.

    k_codes/v_codes (P, H, page, D) int8 pool, k_scale/v_scale
    (P, H, 1, page) f32, page_table (slots, MP) int32, lengths (slots,)
    int32 (positions < lengths are visible), q (slots, H, R, D) f32 with
    R <= 8. Returns (slots, H, R, D) f32; a slot of length 0 gives 0.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`paged_decode_attend_ref`."""
    if not on_cuda(k_codes):
        return paged_decode_attend_ref(k_codes, k_scale, v_codes, v_scale, page_table,
                                       lengths, q)
    out = _launch(k_codes, k_scale, v_codes, v_scale, page_table, lengths, q, None)
    paged_decode_attend.launches += 1
    return out


paged_decode_attend.launches = 0


def paged_decode_attend_cur(
    k_codes, k_scale, v_codes, v_scale, page_table, lengths, q,
    k_cur, k_cur_scale, v_cur, v_cur_scale,
):
    """:func:`paged_decode_attend` over cache[< lengths] plus the current
    token's quantized K/V row (k_cur/v_cur (slots, H, D) int8, scales
    (slots, H) f32) as one more always-visible column; the caller appends
    the same codes to the pool afterwards (``paged_append_batch``)."""
    args = (k_codes, k_scale, v_codes, v_scale, page_table, lengths, q,
            k_cur, k_cur_scale, v_cur, v_cur_scale)
    if not on_cuda(k_codes):
        return paged_decode_attend_cur_ref(*args)
    out = _launch(*args[:7], args[7:])
    paged_decode_attend_cur.launches += 1
    return out


paged_decode_attend_cur.launches = 0
