"""Int8 KV cache for LLM decode.

Counterpart of ``micronet_tpu/quant/kv_cache.py``. Each (head, position)
K or V vector is stored as int8 codes with one f32 scale, symmetric
absmax/127, quantized once when it is appended.

Layout per layer: codes (H, S, D) int8, scales (H, S, 1) f32, and a fill
pointer ``length`` (an int32 tensor on the cache's device, so no step
waits for the host). A batched cache has a leading slot axis on every
leaf and ``length`` of shape (B,).

Unlike the JAX package, whose arrays are immutable, the appends here
write into the cache tensors IN PLACE and return the same cache with its
new length: copying a 1 GB serving cache every step would cost more than
the step itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import torch

from .._device import resolve_device
from ..ops.decode_attention import decode_attend_q8kv
from .rounding import round_half_away

__all__ = [
    "QuantKVCache",
    "init_kv_cache",
    "append_kv",
    "append_kv_batch_quantized",
    "quantize_kv_rows",
    "attend",
    "forward_by_slot",
    "kv_cache_bytes",
]


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: (..., D) -> (codes int8,
    scale (..., 1) f32), round half away from zero. The rule every append
    applies; the deferred-append decode path quantizes the current row
    once with it, feeds the codes to the attention kernel and writes the
    same codes into the cache."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-8).to(torch.float32)
    q = round_half_away(x.to(torch.float32) / scale)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


@dataclasses.dataclass
class QuantKVCache:
    """One layer's quantized KV cache (static max length, fill pointer)."""

    k_codes: torch.Tensor  # (H, S, D) int8, or (B, H, S, D)
    k_scale: torch.Tensor  # (H, S, 1) f32, or (B, H, S, 1)
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor  # int32, () or (B,)

    @property
    def max_seq(self) -> int:
        return self.k_codes.shape[-2]

    def dequant_k(self) -> torch.Tensor:
        return self.k_codes.to(torch.float32) * self.k_scale

    def dequant_v(self) -> torch.Tensor:
        return self.v_codes.to(torch.float32) * self.v_scale


def init_kv_cache(
    num_heads: int,
    max_seq: int,
    head_dim: int,
    *,
    batch: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> QuantKVCache:
    """An empty cache on ``device`` (CUDA unless the caller asks for the
    CPU); ``batch`` adds a leading slot axis."""
    dev = resolve_device(device)
    lead = () if batch is None else (batch,)
    codes = lambda: torch.zeros(lead + (num_heads, max_seq, head_dim),
                                dtype=torch.int8, device=dev)
    scales = lambda: torch.zeros(lead + (num_heads, max_seq, 1),
                                 dtype=torch.float32, device=dev)
    return QuantKVCache(codes(), scales(), codes(), scales(),
                        torch.zeros(lead, dtype=torch.int32, device=dev))


def append_kv(cache: QuantKVCache, k: torch.Tensor, v: torch.Tensor) -> QuantKVCache:
    """Quantize ``k``/``v`` (H, T, D) and write them at the fill pointer,
    in place. Like JAX's ``dynamic_update_slice``, the start clamps so the
    T rows fit; the length grows by T."""
    t = k.shape[1]
    kq, ks = quantize_kv_rows(k)
    vq, vs = quantize_kv_rows(v)
    start = torch.clamp(cache.length, min=0, max=cache.max_seq - t)
    idx = (start + torch.arange(t, device=k.device)).to(torch.int64)
    for buf, val in ((cache.k_codes, kq), (cache.k_scale, ks),
                     (cache.v_codes, vq), (cache.v_scale, vs)):
        buf.index_copy_(1, idx, val)
    cache.length = cache.length + t
    return cache


def append_kv_batch_quantized(
    cache: QuantKVCache,  # batched: leaves (B, H, S, D), length (B,)
    k_codes: torch.Tensor,  # (B, H, D) int8, the current rows
    k_scale: torch.Tensor,  # (B, H) f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
) -> QuantKVCache:
    """Single-token append on a batched cache, each slot at its own fill
    pointer, in place. A full slot clamps its write to the last row and
    its length saturates at S (the serving loop finishes slots at
    max_seq, so this is a backstop)."""
    b = k_codes.shape[0]
    s = cache.max_seq
    rows = torch.arange(b, device=k_codes.device)
    i = torch.clamp(cache.length, max=s - 1).to(torch.int64)
    cache.k_codes[rows, :, i, :] = k_codes
    cache.k_scale[rows, :, i, 0] = k_scale
    cache.v_codes[rows, :, i, :] = v_codes
    cache.v_scale[rows, :, i, 0] = v_scale
    cache.length = torch.clamp(cache.length + 1, max=s)
    return cache


def attend(
    cache: QuantKVCache,
    q: torch.Tensor,  # (H_q, T, D)
    *,
    causal_offset: Union[int, torch.Tensor, None] = None,
) -> torch.Tensor:
    """Multi-head attention of ``q`` against the cache: positions at or
    past the fill pointer are masked and, with ``causal_offset`` (the
    absolute position of q's first token), query t sees no position past
    ``causal_offset + t``. GQA: ``q`` may carry r * H_kv heads; query
    head i reads KV group i // r.

    Decode (T = 1) runs the fused int8-KV kernel
    (:func:`..ops.decode_attention.decode_attend_q8kv`). Prefill (T > 1)
    stays plain PyTorch in f32, as the JAX package leaves it to XLA."""
    hq, t, d = q.shape
    h = cache.k_codes.shape[0]
    if hq % h:
        raise ValueError(f"query heads {hq} not a multiple of KV heads {h}")
    r = hq // h
    s = cache.max_seq
    if t == 1:
        bound = cache.length
        if causal_offset is not None:
            bound = torch.minimum(bound, torch.as_tensor(
                causal_offset, dtype=torch.int32, device=q.device) + 1)
        bound = bound.to(torch.int32).reshape(1).expand(h).contiguous()
        q_in = q[:, 0, :].to(torch.float32).contiguous()
        out = decode_attend_q8kv(
            cache.k_codes,
            cache.k_scale.reshape(h, s),
            cache.v_codes,
            cache.v_scale.reshape(h, s),
            q_in.reshape(h, r, d) if r > 1 else q_in,
            bound,
        )
        return out.reshape(hq, 1, d).to(q.dtype)
    kf = cache.dequant_k()
    vf = cache.dequant_v()
    if r > 1:  # GQA prefill: repeat KV groups across their query heads
        kf = torch.repeat_interleave(kf, r, dim=0)
        vf = torch.repeat_interleave(vf, r, dim=0)
    logits = torch.einsum("htd,hsd->hts", q.to(torch.float32), kf)
    logits = logits / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    pos = torch.arange(s, device=q.device)[None, None, :]
    valid = pos < cache.length
    if causal_offset is not None:
        tq = causal_offset + torch.arange(t, device=q.device)[None, :, None]
        valid = valid & (pos <= tq)
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hts,hsd->htd", probs, vf).to(q.dtype)


def forward_by_slot(
    forward: Callable,  # forward(tokens (T,), caches, offset) -> (logits, caches)
    tokens: torch.Tensor,  # (B, T)
    caches: List[QuantKVCache],  # batched per-layer caches
    offsets: torch.Tensor,  # (B,)
) -> Tuple[torch.Tensor, List[QuantKVCache]]:
    """A model's ``forward_batch``: ``forward`` for each slot on its own
    view of the batched caches, in turn (what the JAX package's vmap
    computes). Logits (B, T, vocab) and the caches, appended in place."""
    logits = []
    for b, off in enumerate(offsets.tolist()):
        views = [QuantKVCache(c.k_codes[b], c.k_scale[b], c.v_codes[b], c.v_scale[b],
                              c.length[b]) for c in caches]
        out, views = forward(tokens[b], views, off)
        for c, v in zip(caches, views):
            c.length[b] = v.length
        logits.append(out)
    return torch.stack(logits), caches


def kv_cache_bytes(cache: QuantKVCache) -> int:
    """Storage bytes (codes, scales and fill pointer)."""
    leaves = (getattr(cache, f.name) for f in dataclasses.fields(cache))
    return sum(t.numel() * t.element_size() for t in leaves)
