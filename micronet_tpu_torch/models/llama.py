"""Llama-family causal decoder, the serving model.

Counterpart of ``micronet_tpu/models/llama.py``: grouped-query attention,
rotary position embeddings (rotate-half), RMSNorm, SwiGLU, and fused
projections (one QKV matmul, one gate+up matmul). With ``w4_group`` the
block matmuls and the lm_head are weight-only int4 (hl8-packed, group
scales) on the W4A16 kernel; the KV cache is int8 and decode runs the
fused int8-KV attention kernels.

Serving API (the :class:`..serve.ServeLoop` contract): ``init_cache``,
``init_cache_batch``, ``forward`` (prefill, or T = 1 decode),
``forward_batch`` (``forward`` for each slot of a batched cache),
``decode_batch`` (one token for each of B slots) and, over a paged KV
pool, ``init_paged_cache`` and ``decode_batch_paged``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..nn.modules import Linear
from ..ops.decode_attention import decode_attend_q8kv_cur
from ..ops.paged_attention import paged_decode_attend_cur
from ..quant.kv_cache import (
    QuantKVCache,
    append_kv,
    append_kv_batch_quantized,
    attend,
    forward_by_slot,
    init_kv_cache,
    quantize_kv_rows,
)
from ..quant.paged_kv import PagedKVCache, init_paged_kv, paged_append_batch
from ..quant.weight_only import wo_quantize_linear
from ..serve.sampling import generate_sampled

__all__ = [
    "LlamaConfig",
    "llama3_8b",
    "llama_tiny",
    "apply_rope",
    "apply_rope_batch",
    "RMSNorm",
    "LlamaBlock",
    "Llama",
    "quantize_llama",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-family geometry (field names follow the published configs)."""

    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    mlp_dim: int
    max_seq: int
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def llama3_8b(max_seq: int = 2048) -> LlamaConfig:
    """The Llama-3-8B geometry (GQA 32q/8kv, 14336 SwiGLU, theta 5e5)."""
    return LlamaConfig(
        vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_dim=14336, max_seq=max_seq, rope_theta=500000.0,
    )


def llama_tiny(max_seq: int = 32) -> LlamaConfig:
    """Test-scale config with the same shape of everything (GQA ratio 2,
    even head_dim, fused projections)."""
    return LlamaConfig(
        vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=64, max_seq=max_seq, rope_theta=10000.0,
    )


def _rope(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x (..., D) by angles broadcastable to
    (..., D/2); trig in f32 whatever x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _inv_freq(d: int, theta: float, device) -> torch.Tensor:
    """``theta ** (-arange(0, D/2) / (D/2))`` in f32, as the JAX package
    computes it (f32 exponent, f32 power)."""
    half = d // 2
    e = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE of x (H, T, D) at absolute ``positions`` (T,)."""
    inv = _inv_freq(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]  # (T, D/2)
    return _rope(x, ang[None])


def apply_rope_batch(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE for the batched decode step: x (B, H, D), one token per slot at
    ``positions`` (B,). Same elementwise ops as :func:`apply_rope`, so a
    request's numbers do not depend on what shares its batch."""
    inv = _inv_freq(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]  # (B, D/2)
    return _rope(x, ang[:, None, :])


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ms = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
        return (x * torch.rsqrt(ms + self.eps) * self.weight).to(x.dtype)


class LlamaBlock(nn.Module):
    """Pre-norm GQA attention + SwiGLU MLP with fused projections."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        lin = lambda i, o: Linear(i, o, bias=False, device=dev, generator=generator)
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=dev)
        # fused QKV: columns [0, dim) are q, [dim, dim + kv_dim) k, the rest v
        self.wqkv = lin(cfg.dim, cfg.dim + 2 * cfg.kv_dim)
        self.wo = lin(cfg.dim, cfg.dim)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=dev)
        # fused gate+up: columns [0, mlp) gate, [mlp, 2 * mlp) up
        self.gateup = lin(cfg.dim, 2 * cfg.mlp_dim)
        self.down = lin(cfg.mlp_dim, cfg.dim)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        gu = self.gateup(self.mlp_norm(x))
        m = self.cfg.mlp_dim
        return x + self.down(F.silu(gu[..., :m]) * gu[..., m:])

    def forward(
        self,
        x: torch.Tensor,  # (T, dim), one request
        cache: QuantKVCache,
        offset: int,  # absolute position of x[0]
    ) -> Tuple[torch.Tensor, QuantKVCache]:
        cfg = self.cfg
        t = x.shape[0]
        hd = cfg.head_dim
        qkv = self.wqkv(self.attn_norm(x))
        q = qkv[:, : cfg.dim].reshape(t, cfg.n_heads, hd).transpose(0, 1)
        k = qkv[:, cfg.dim : cfg.dim + cfg.kv_dim].reshape(t, cfg.n_kv_heads, hd).transpose(0, 1)
        v = qkv[:, cfg.dim + cfg.kv_dim :].reshape(t, cfg.n_kv_heads, hd).transpose(0, 1)
        pos = offset + torch.arange(t, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        cache = append_kv(cache, k, v)
        att = attend(cache, q, causal_offset=offset)  # (n_heads, T, D)
        x = x + self.wo(att.transpose(0, 1).reshape(t, cfg.dim))
        return self._mlp(x), cache

    def _rows_batch(self, x: torch.Tensor, offsets: torch.Tensor):
        """A batched decode step's projections and RoPE: q (B, hkv, r, D)
        f32 (query head i reads KV group i // r, so this keeps head order)
        and the current rows quantized once, codes (B, hkv, D) int8 and
        scales (B, hkv) f32 for K then V."""
        cfg = self.cfg
        b = x.shape[0]
        hkv, d = cfg.n_kv_heads, cfg.head_dim
        qkv = self.wqkv(self.attn_norm(x))
        q = qkv[:, : cfg.dim].reshape(b, cfg.n_heads, d)
        k = qkv[:, cfg.dim : cfg.dim + cfg.kv_dim].reshape(b, hkv, d)
        v = qkv[:, cfg.dim + cfg.kv_dim :].reshape(b, hkv, d)
        q = apply_rope_batch(q, offsets, cfg.rope_theta)
        k = apply_rope_batch(k, offsets, cfg.rope_theta)
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        q = q.reshape(b, hkv, cfg.n_heads // hkv, d).to(torch.float32).contiguous()
        return q, kq, ks[..., 0], vq, vs[..., 0]

    def _finish_batch(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        x = x + self.wo(att.reshape(x.shape[0], self.cfg.dim).to(x.dtype))
        return self._mlp(x)

    def step_batch(
        self,
        x: torch.Tensor,  # (B, dim), one token per slot
        cache: QuantKVCache,  # batched: leaves (B, H, S, D), length (B,)
        offsets: torch.Tensor,  # (B,) int32 absolute position of each token
    ) -> Tuple[torch.Tensor, QuantKVCache]:
        """Batched decode step, the serving throughput path: every
        projection runs once at M = B, attention folds the batch into the
        kernel's grid (G = B * n_kv_heads).

        Deferred append: the current K/V rows are quantized once, attended
        as an extra column over the PRE-append cache (bound = min(length,
        offset)), and the same codes are then written into the cache."""
        q, kq, ks, vq, vs = self._rows_batch(x, offsets)
        b, hkv, r, d = q.shape
        s = self.cfg.max_seq
        g = b * hkv
        bound = torch.minimum(cache.length, offsets).to(torch.int32)
        att = decode_attend_q8kv_cur(
            cache.k_codes.reshape(g, s, d), cache.k_scale.reshape(g, s),
            cache.v_codes.reshape(g, s, d), cache.v_scale.reshape(g, s),
            q.reshape(g, r, d), bound[:, None].expand(b, hkv).reshape(g).contiguous(),
            kq.reshape(g, d), ks.reshape(g), vq.reshape(g, d), vs.reshape(g),
        )  # (B * hkv, r, D)
        cache = append_kv_batch_quantized(cache, kq, ks, vq, vs)
        return self._finish_batch(x, att), cache

    def step_batch_paged(
        self,
        x: torch.Tensor,  # (B, dim), one token per slot
        cache: PagedKVCache,  # the pool shared by the B slots
        offsets: torch.Tensor,  # (B,) int32
        active: torch.Tensor,  # (B,) bool: inactive lanes append nothing
    ) -> Tuple[torch.Tensor, PagedKVCache]:
        """:meth:`step_batch` over a paged pool: the same deferred-append
        math, attention read straight from the pages, and the append
        popping pages for active lanes only (an idle lane's append would
        leak pages from the shared pool)."""
        q, kq, ks, vq, vs = self._rows_batch(x, offsets)
        bound = torch.minimum(cache.lengths, offsets).to(torch.int32)
        att = paged_decode_attend_cur(
            cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale,
            cache.page_table, bound, q, kq, ks, vq, vs,
        )  # (B, hkv, r, D)
        cache = paged_append_batch(cache, kq, ks, vq, vs, active)
        return self._finish_batch(x, att), cache


class Llama(nn.Module):
    """Causal Llama-family LM (ServeLoop-compatible).

    Weights are random, drawn from ``generator`` (a fresh one seeded 0 on
    ``device`` when none is given). ``w4_group > 0`` quantizes each block
    as it is built, and the lm_head unless ``quantize_lm_head=False``, so
    the f32 transient peaks at one block (about 0.9 GB at the 8B
    geometry) instead of the whole float model. ``device`` defaults to
    CUDA and raises when no card is present."""

    def __init__(
        self,
        cfg: LlamaConfig,
        *,
        w4_group: int = 0,
        w4_bits: int = 4,
        quantize_lm_head: bool = True,
        device: Union[str, torch.device, None] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.device = dev
        self.embed = nn.Parameter(
            torch.randn((cfg.vocab, cfg.dim), generator=generator, device=dev) * 0.02
        )
        blocks = []
        for _ in range(cfg.n_layers):
            blk = LlamaBlock(cfg, device=dev, generator=generator)
            if w4_group:
                _quantize_block(blk, w4_group, w4_bits)
            blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, device=dev)
        self.lm_head = Linear(cfg.dim, cfg.vocab, bias=False, device=dev,
                              generator=generator)
        if w4_group and quantize_lm_head:
            # the lm_head is read in full for every decoded token
            self.lm_head = wo_quantize_linear(self.lm_head, w4_group, w4_bits)
        self.requires_grad_(False)

    # -- serving API --------------------------------------------------------

    @property
    def max_seq(self) -> int:
        """KV rows a request may hold (the serving loop's capacity)."""
        return self.cfg.max_seq

    def init_cache(self) -> List[QuantKVCache]:
        cfg = self.cfg
        return [init_kv_cache(cfg.n_kv_heads, cfg.max_seq, cfg.head_dim,
                              device=self.device)
                for _ in range(cfg.n_layers)]

    def init_cache_batch(self, batch: int) -> List[QuantKVCache]:
        cfg = self.cfg
        return [init_kv_cache(cfg.n_kv_heads, cfg.max_seq, cfg.head_dim,
                              batch=batch, device=self.device)
                for _ in range(cfg.n_layers)]

    def init_paged_cache(self, slots: int, page_size: int,
                         num_pages: int) -> List[PagedKVCache]:
        """A paged pool per layer of ``num_pages`` pages, sized to the
        expected sum of live lengths; each slot still holds up to max_seq
        rows (``max_seq // page_size`` pages)."""
        cfg = self.cfg
        if cfg.max_seq % page_size:
            raise ValueError(f"page_size {page_size} must divide max_seq {cfg.max_seq}")
        return [init_paged_kv(num_pages, page_size, cfg.n_kv_heads, cfg.head_dim, slots,
                              cfg.max_seq // page_size, device=self.device)
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def forward(
        self,
        tokens: torch.Tensor,  # (T,) integer
        caches: List[QuantKVCache],
        offset: int,  # absolute position of tokens[0]
    ) -> Tuple[torch.Tensor, List[QuantKVCache]]:
        """Prefill (T > 1) or decode (T = 1): logits (T, vocab) and the
        caches, appended in place."""
        x = self.embed[tokens]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, offset)
            new_caches.append(cache)
        return self.lm_head(self.norm(x)), new_caches

    @torch.no_grad()
    def forward_batch(
        self,
        tokens: torch.Tensor,  # (B, T)
        caches: List[QuantKVCache],  # batched per-layer caches
        offsets: torch.Tensor,  # (B,)
    ) -> Tuple[torch.Tensor, List[QuantKVCache]]:
        """:meth:`forward` for each slot on its own cache, in turn
        (:func:`..quant.kv_cache.forward_by_slot`)."""
        return forward_by_slot(self.forward, tokens, caches, offsets)

    @torch.no_grad()
    def decode_batch(
        self,
        tokens: torch.Tensor,  # (B, 1)
        caches: List[QuantKVCache],  # batched per-layer caches
        offsets: torch.Tensor,  # (B,) int32
    ) -> Tuple[torch.Tensor, List[QuantKVCache]]:
        """Batched decode, one token per slot: logits (B, 1, vocab) and
        the caches, appended in place."""
        x = self.embed[tokens[:, 0]]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk.step_batch(x, cache, offsets)
            new_caches.append(cache)
        return self.lm_head(self.norm(x))[:, None, :], new_caches

    @torch.no_grad()
    def decode_batch_paged(
        self,
        tokens: torch.Tensor,  # (B, 1)
        caches: List[PagedKVCache],  # from init_paged_cache
        offsets: torch.Tensor,  # (B,) int32
        active: torch.Tensor,  # (B,) bool, the loop's occupied slots
    ) -> Tuple[torch.Tensor, List[PagedKVCache]]:
        """:meth:`decode_batch` over the paged pools: logits (B, 1, vocab)
        and the pools, appended in place for active slots."""
        x = self.embed[tokens[:, 0]]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk.step_batch_paged(x, cache, offsets, active)
            new_caches.append(cache)
        return self.lm_head(self.norm(x))[:, None, :], new_caches

    def generate(self, prompt: torch.Tensor, steps: int) -> torch.Tensor:
        """Greedy decode of ``steps`` tokens after ``prompt`` (T,)."""
        return generate_sampled(self, prompt, steps)


def _quantize_block(blk: LlamaBlock, group: int, bits: int) -> None:
    for name in ("wqkv", "wo", "gateup", "down"):
        setattr(blk, name, wo_quantize_linear(getattr(blk, name), group, bits))


def quantize_llama(model: Llama, group: int = 128, bits: int = 4) -> Llama:
    """Every block matmul (fused QKV, output proj, fused gate+up, down)
    becomes weight-only int4/int8, in place. Embedding, norms and the
    lm_head stay float (build with ``w4_group`` to quantize the lm_head
    too)."""
    for blk in model.blocks:
        _quantize_block(blk, group, bits)
    return model
