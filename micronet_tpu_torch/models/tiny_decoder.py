"""Minimal causal decoder, the serving kit's demo model: the counterpart of
``micronet_tpu/models/tiny_decoder.py``.

A learned position table (no RoPE), RMSNorm (eps 1e-6), multi-head
attention over the int8 KV cache and a GELU MLP, or a MoE MLP
(:mod:`..parallel.moe`) with ``moe_experts``. :func:`quantize_decoder`
turns every block linear into weight-only int4 (or int8); MoE blocks
quantize their experts to int8. The embedding, the position table, the
norms and the lm_head stay float.

Kernels on the W4 path: every block linear runs the W4A16 kernel K3
(``WOTensor.matmul``, where the group divides K/2) and decode (T = 1)
attention runs K5a (``quant.kv_cache.attend``). MoE experts run as f32
einsums on their dequantized int8 weights, as the JAX package leaves
them to XLA.

Serving API (the :class:`..serve.ServeLoop` contract): ``init_cache``,
``init_cache_batch``, ``forward`` (prefill, or T = 1 decode) and
``forward_batch`` (``forward`` for each slot of a batched cache, in turn,
where the JAX package vmaps). There is no batched decode step and no
paged cache, as in the JAX package.

Parallel serving: ``parallel.shard_state`` shards every W4 linear (and the
float lm_head) by column over a ``model`` axis; ``MoEMLP.use_ep`` serves
a MoE block expert-parallel over an ``expert`` axis; ``prefill_sp`` runs
the prompt's attention as ring attention over a ``seq`` axis
(``parallel.sequence``) and writes the same int8 cache as ``forward``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..nn.modules import Linear
from ..parallel.moe import MoEParams, init_moe, moe_apply, moe_apply_ep, quantize_moe
from ..quant.kv_cache import QuantKVCache, append_kv, attend, forward_by_slot, init_kv_cache
from ..quant.weight_only import wo_quantize_linear
from ..serve.sampling import generate_sampled
from .llama import RMSNorm

__all__ = ["TinyDecoder", "DecoderBlock", "MoEMLP", "quantize_decoder"]

_NORM_EPS = 1e-6  # the JAX package's RMSNorm here (Llama's is 1e-5)


def _load_local_experts(moe: "MoEMLP", state_dict, prefix, *_args) -> None:
    """Loading into an EP block: a whole-E expert tensor becomes the rank's
    slice."""
    if moe.ep_mesh is None:
        return
    from ..parallel.sharding import axis_rank, axis_size

    size, rank = axis_size(moe.ep_mesh, moe.ep_axis), axis_rank(moe.ep_mesh, moe.ep_axis)
    e = moe.n_experts // size
    for name in moe._EXPERT_TENSORS:
        t = state_dict.get(prefix + name)
        if t is not None and t.shape[0] == moe.n_experts and size > 1:
            state_dict[prefix + name] = t[rank * e:(rank + 1) * e]


class MoEMLP(nn.Module):
    """MoE MLP block over :func:`..parallel.moe.moe_apply`. Serving is
    drop-free by default (``capacity_factor`` 0 means E, so capacity is k
    x T): a token's output must not depend on the tokens sharing its
    forward, or prefill and incremental decode would disagree."""

    def __init__(self, dim: int, mlp_dim: int, n_experts: int, capacity_factor: float = 0.0,
                 top_k: int = 1, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        p = init_moe(dim, mlp_dim, n_experts, device=device, generator=generator)
        self.router = nn.Parameter(p.router)
        self.w_up = nn.Parameter(p.w_up)
        self.w_down = nn.Parameter(p.w_down)
        self.register_buffer("up_scale", None)
        self.register_buffer("down_scale", None)
        self.capacity_factor = capacity_factor or float(n_experts)
        self.top_k = top_k
        self.n_experts = n_experts
        self.ep_mesh, self.ep_axis = None, "expert"
        self._register_load_state_dict_pre_hook(_load_local_experts, with_module=True)

    def params(self) -> MoEParams:
        return MoEParams(self.router, self.w_up, self.w_down, self.up_scale, self.down_scale)

    def quantize_(self) -> None:
        """Int8 weight-only experts, in place (serving only): the codes and
        scales become buffers, so they leave ``parameters()``."""
        qp = quantize_moe(self.params())
        for name in ("w_up", "w_down"):
            delattr(self, name)
            self.register_buffer(name, getattr(qp, name))
        self.register_buffer("up_scale", qp.up_scale)
        self.register_buffer("down_scale", qp.down_scale)

    _EXPERT_TENSORS = ("w_up", "w_down", "up_scale", "down_scale")

    def use_ep(self, mesh, axis: str = "expert") -> None:
        """Serve this block expert-parallel over ``mesh``'s ``axis``
        (:func:`..parallel.moe.moe_apply_ep`, top-1 only, as in JAX): the
        rank keeps its E/ep experts (codes and scales, or float weights)
        and drops the rest. The mesh is module configuration, so a
        ``state_dict`` round trip keeps the EP dispatch: the state holds
        the rank's experts, and loading a whole-E state (a dense model's)
        takes the rank's slice. Same router, same drop-free capacity, so
        the logits equal the dense path's up to the order of the
        combine's sums."""
        from ..parallel.sharding import axis_rank, axis_size

        if self.top_k != 1:
            raise ValueError(f"use_ep is top-1 (moe_apply_ep); this block routes top-"
                             f"{self.top_k}: use parallel.moe.moe_apply_ep_a2a")
        size, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
        if self.n_experts % size:
            raise ValueError(f"{self.n_experts} experts do not divide over {size} ranks")
        if self.ep_mesh is None:
            e = self.n_experts // size
            with torch.no_grad():
                for name in self._EXPERT_TENSORS:
                    t = getattr(self, name)
                    if t is not None:
                        local = t.detach()[rank * e:(rank + 1) * e].clone()
                        if isinstance(t, nn.Parameter):
                            t.data = local
                        else:
                            setattr(self, name, local)
        self.ep_mesh, self.ep_axis = mesh, axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ep_mesh is not None:
            return moe_apply_ep(self.params(), x, self.ep_mesh, self.ep_axis,
                                self.capacity_factor)
        return moe_apply(self.params(), x, self.capacity_factor, self.top_k)


class DecoderBlock(nn.Module):
    """Pre-norm multi-head attention over the int8 KV cache, then a GELU
    MLP or a :class:`MoEMLP`."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, *, moe_experts: int = 0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        dev = resolve_device(device)
        lin = lambda i, o: Linear(i, o, bias=False, device=dev, generator=generator)
        self.heads = heads
        self.head_dim = dim // heads
        self.norm1 = RMSNorm(dim, _NORM_EPS, device=dev)
        self.wq, self.wk, self.wv, self.wo = (lin(dim, dim) for _ in range(4))
        self.norm2 = RMSNorm(dim, _NORM_EPS, device=dev)
        if moe_experts:
            self.moe = MoEMLP(dim, mlp_dim, moe_experts, device=dev, generator=generator)
        else:
            self.moe = None
            self.up = lin(dim, mlp_dim)
            self.down = lin(mlp_dim, dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], self.heads, self.head_dim).transpose(0, 1)

    def forward(
        self,
        x: torch.Tensor,  # (T, dim), one request
        cache: QuantKVCache,
        offset: Union[int, torch.Tensor],  # absolute position of x[0]
    ) -> Tuple[torch.Tensor, QuantKVCache]:
        h = self.norm1(x)
        q, k, v = self._split(self.wq(h)), self._split(self.wk(h)), self._split(self.wv(h))
        cache = append_kv(cache, k, v)
        att = attend(cache, q, causal_offset=offset)  # (H, T, D)
        x = x + self.wo(att.transpose(0, 1).reshape(x.shape[0], -1))
        return self._mlp(x), cache

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h2 = self.norm2(x)
        if self.moe is not None:
            return x + self.moe(h2)
        return x + self.down(F.gelu(self.up(h2), approximate="tanh"))

    def prefill_sp(
        self,
        x: torch.Tensor,  # (T, dim), the whole prompt
        cache: QuantKVCache,  # empty (fill pointer 0)
        mesh,
        axis: str = "seq",
    ) -> Tuple[torch.Tensor, QuantKVCache]:
        """Sequence-parallel prefill: the prompt's attention is exact ring
        attention over ``mesh``'s ``axis``, and the K/V land in the int8
        cache as :meth:`forward` writes them, so later decode steps are the
        same bits as after a dense prefill. The ring reads the dequantized
        cache rows, the values ``attend`` reads in a dense prefill, so the
        logits agree with :meth:`forward` up to the order of the sums."""
        from ..parallel.sequence import ring_attention

        t = x.shape[0]
        h = self.norm1(x)
        q, k, v = self._split(self.wq(h)), self._split(self.wk(h)), self._split(self.wv(h))
        cache = append_kv(cache, k, v)
        kdq = cache.dequant_k()[:, :t]  # (H, T, D)
        vdq = cache.dequant_v()[:, :t]
        att = ring_attention(q.transpose(0, 1).to(torch.float32), kdq.transpose(0, 1),
                             vdq.transpose(0, 1), mesh, axis=axis, causal=True).to(x.dtype)
        x = x + self.wo(att.reshape(t, -1))
        return self._mlp(x), cache


class TinyDecoder(nn.Module):
    """Causal decoder LM over a token vocabulary (unbatched forward).

    Weights are random, drawn from ``generator`` (a fresh one seeded 0 on
    ``device`` when none is given). MoE blocks route top-1; set ``top_k``
    on each block's ``moe`` for top-2, as with the JAX package's model.
    ``device`` defaults to CUDA and raises when no card is present."""

    def __init__(self, vocab: int = 256, dim: int = 64, heads: int = 4, depth: int = 2,
                 mlp_dim: int = 128, max_seq: int = 64, moe_experts: int = 0, *,
                 device: Union[str, torch.device, None] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.device = dev
        self.vocab, self.dim, self.max_seq = vocab, dim, max_seq
        self.heads, self.depth = heads, depth
        randn = lambda *shape: torch.randn(shape, generator=generator, device=dev)
        self.embed = nn.Parameter(randn(vocab, dim) * 0.02)
        self.pos = nn.Parameter(randn(max_seq, dim) * 0.02)
        self.blocks = nn.ModuleList(
            DecoderBlock(dim, heads, mlp_dim, moe_experts=moe_experts, device=dev,
                         generator=generator) for _ in range(depth))
        self.norm = RMSNorm(dim, _NORM_EPS, device=dev)
        self.lm_head = Linear(dim, vocab, bias=False, device=dev, generator=generator)
        self.requires_grad_(False)

    # -- serving API --------------------------------------------------------

    def init_cache(self) -> List[QuantKVCache]:
        return [init_kv_cache(self.heads, self.max_seq, self.dim // self.heads,
                              device=self.device) for _ in range(self.depth)]

    def init_cache_batch(self, batch: int) -> List[QuantKVCache]:
        return [init_kv_cache(self.heads, self.max_seq, self.dim // self.heads, batch=batch,
                              device=self.device) for _ in range(self.depth)]

    @torch.no_grad()
    def forward(
        self,
        tokens: torch.Tensor,  # (T,) integer
        caches: List[QuantKVCache],
        offset: Union[int, torch.Tensor],  # absolute position of tokens[0]
    ) -> Tuple[torch.Tensor, List[QuantKVCache]]:
        """Prefill (T > 1) or decode (T = 1): logits (T, vocab) and the
        caches, appended in place."""
        pos_ids = offset + torch.arange(tokens.shape[0], device=tokens.device)
        # past the table the last row, as JAX's gather clamps: the serving
        # loop steps idle slots on, whose offsets outgrow max_seq
        x = self.embed[tokens] + self.pos[pos_ids.clamp(max=self.max_seq - 1)]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, offset)
            new_caches.append(cache)
        return self.lm_head(self.norm(x)), new_caches

    @torch.no_grad()
    def prefill_sp(
        self,
        tokens: torch.Tensor,  # (T,), T divisible by the axis
        caches: List[QuantKVCache],  # fresh (init_cache())
        mesh,
        axis: str = "seq",
    ) -> Tuple[torch.Tensor, List[QuantKVCache]]:
        """Sequence-parallel prefill over ``mesh``'s ``axis``: logits and
        caches of :meth:`forward` (tokens, caches, 0), the caches' codes
        bit for bit, the logits up to the order of the sums."""
        t = tokens.shape[0]
        x = self.embed[tokens] + self.pos[torch.arange(t, device=tokens.device)]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk.prefill_sp(x, cache, mesh, axis)
            new_caches.append(cache)
        return self.lm_head(self.norm(x)), new_caches

    def forward_batch(
        self,
        tokens: torch.Tensor,  # (B, T)
        caches: List[QuantKVCache],  # batched per-layer caches
        offsets: torch.Tensor,  # (B,)
    ) -> Tuple[torch.Tensor, List[QuantKVCache]]:
        """:meth:`forward` for each slot on its own cache, in turn
        (:func:`..quant.kv_cache.forward_by_slot`): logits (B, T, vocab)
        and the caches, appended in place."""
        return forward_by_slot(self.forward, tokens, caches, offsets)

    def generate(self, prompt: torch.Tensor, steps: int) -> torch.Tensor:
        """Greedy decode of ``steps`` tokens after ``prompt`` (T,)."""
        return generate_sampled(self, prompt, steps)


def quantize_decoder(model: TinyDecoder, group: int = 0, bits: int = 4) -> TinyDecoder:
    """Every block linear (attention projections and, in dense blocks, the
    MLP) becomes weight-only int4 or int8, in place; MoE blocks quantize
    their experts to int8 (per expert and column). The embedding, the
    position table, the norms and the lm_head stay float."""
    for blk in model.blocks:
        names = ("wq", "wk", "wv", "wo") + (() if blk.moe is not None else ("up", "down"))
        for name in names:
            setattr(blk, name, wo_quantize_linear(getattr(blk, name), group, bits))
        if blk.moe is not None:
            blk.moe.quantize_()
    return model
