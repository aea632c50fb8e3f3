"""Paged int8 KV cache: KV rows in fixed-size pages drawn from one shared
pool, so memory follows the sum of live lengths, not ``slots * max_seq``.

Counterpart of ``micronet_tpu/quant/paged_kv.py``, with the same layout
and the same allocator, field for field:

- ``k_codes``/``v_codes`` (P, H, page, D) int8 and ``k_scale``/``v_scale``
  (P, H, 1, page) f32: the pool;
- ``page_table`` (slots, max_pages) int32: slot s's i-th logical page is
  pool page ``page_table[s, i]``; unallocated entries hold page 0, the
  reserved zero page, which stays all zero and never enters the free
  list;
- ``lengths`` (slots,) int32 fill pointers;
- ``free_stack`` (P,) int32 and ``free_top`` (a 0-dim int32 tensor): a
  LIFO of free pages, handing out pages 1, 2, ..., P-1 in that order.

Everything stays on the cache's device, so no decode step waits for the
host. Unlike the JAX package, whose arrays are immutable, every function
here updates the cache IN PLACE and returns it. JAX drops the writes of
a skipped append with an out-of-range index (``mode="drop"``); torch's
indexing raises on such an index, so a dropped write here goes to the
zero page with zero values, which leaves it as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from .._device import resolve_device
from .kv_cache import quantize_kv_rows

__all__ = [
    "PagedKVCache",
    "init_paged_kv",
    "paged_alloc_slot",
    "paged_free_slot",
    "paged_append",
    "paged_append_batch",
    "paged_insert_from_dense",
    "paged_gather_dense",
    "paged_hbm_bytes",
]

_I32 = torch.int32


@dataclasses.dataclass
class PagedKVCache:
    k_codes: torch.Tensor  # (P, H, page, D) int8
    k_scale: torch.Tensor  # (P, H, 1, page) f32
    v_codes: torch.Tensor  # (P, H, page, D) int8
    v_scale: torch.Tensor  # (P, H, 1, page) f32
    page_table: torch.Tensor  # (slots, max_pages) int32 (0 = the zero page)
    lengths: torch.Tensor  # (slots,) int32
    free_stack: torch.Tensor  # (P,) int32 LIFO of free pool pages
    free_top: torch.Tensor  # () int32: free pages on the stack

    @property
    def page_size(self) -> int:
        return self.k_codes.shape[2]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]


def init_paged_kv(
    num_pages: int,
    page_size: int,
    num_heads: int,
    head_dim: int,
    slots: int,
    max_pages_per_slot: int,
    *,
    device: Union[str, torch.device, None] = None,
) -> PagedKVCache:
    """A pool of ``num_pages`` pages on ``device`` (CUDA unless the caller
    asks for the CPU). Page 0 is the reserved zero page; the free list
    holds pages 1..P-1, top of stack at index ``free_top - 1``, so pops
    give 1, 2, ..., P-1 (index P-1 holds a zero that is never read)."""
    dev = resolve_device(device)
    p = num_pages
    codes = lambda: torch.zeros((p, num_heads, page_size, head_dim), dtype=torch.int8,
                                device=dev)
    scales = lambda: torch.zeros((p, num_heads, 1, page_size), dtype=torch.float32,
                                 device=dev)
    return PagedKVCache(
        k_codes=codes(), k_scale=scales(), v_codes=codes(), v_scale=scales(),
        page_table=torch.zeros((slots, max_pages_per_slot), dtype=_I32, device=dev),
        lengths=torch.zeros((slots,), dtype=_I32, device=dev),
        free_stack=torch.cat([torch.arange(p - 1, 0, -1, dtype=_I32, device=dev),
                              torch.zeros((1,), dtype=_I32, device=dev)]),
        free_top=torch.tensor(p - 1, dtype=_I32, device=dev),
    )


def _pages_used(length: torch.Tensor, page_size: int) -> torch.Tensor:
    return (length + page_size - 1) // page_size


def paged_free_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Return ``slot``'s pages to the free list, pushed in page-table
    order, and zero its table row and length. Pages are not zeroed: the
    next appends overwrite them and attention masks past ``lengths``."""
    mp = cache.max_pages
    p = cache.free_stack.shape[0]
    dev = cache.free_stack.device
    row = cache.page_table[slot]
    idx = torch.arange(mp, device=dev)
    # page > 0: a corrupt entry must never push the zero page
    push = (idx < _pages_used(cache.lengths[slot], cache.page_size)) & (row > 0)
    n = push.to(_I32)
    pos = cache.free_top + torch.cumsum(n, 0, dtype=_I32) - n  # exclusive ranks
    # pushes that do not happen land in a spill area past the stack
    spill = torch.cat([cache.free_stack, cache.free_stack.new_zeros(mp)])
    spill[torch.where(push, pos, p + idx).to(torch.int64)] = row
    cache.free_stack.copy_(spill[:p])
    cache.free_top = cache.free_top + n.sum(dtype=_I32)
    cache.page_table[slot] = 0
    cache.lengths[slot] = 0
    return cache


paged_alloc_slot = paged_free_slot  # eviction and reset are one operation


def paged_append_batch(
    cache: PagedKVCache,
    k_codes: torch.Tensor,  # (B, H, D) int8, the current rows, B = slots
    k_scale: torch.Tensor,  # (B, H) f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    active: torch.Tensor,  # (B,) bool: inactive slots append nothing
) -> PagedKVCache:
    """One-token append for every active slot at once, the paged serving
    loop's deferred append. Slots starting a fresh page pop consecutive
    pages off the stack, ranked by an exclusive cumsum. An append is
    skipped (no write, no length increment, no pop) when the slot is at
    capacity (``max_pages * page_size`` rows) or needs a page when the
    stack has run out. Inactive lanes never pop."""
    ps, mp = cache.page_size, cache.max_pages
    b = k_codes.shape[0]
    rows = torch.arange(b, device=k_codes.device)
    i = cache.lengths
    page_idx = torch.clamp(i // ps, max=mp - 1).to(torch.int64)
    offset = (i % ps).to(torch.int64)
    need_new = active & (offset == 0) & (i < mp * ps)
    nn = need_new.to(_I32)
    rank = torch.cumsum(nn, 0, dtype=_I32) - nn
    can_alloc = rank < cache.free_top
    new_page = cache.free_stack[torch.clamp(cache.free_top - 1 - rank, min=0).to(torch.int64)]
    ok = active & (i < mp * ps) & (~need_new | can_alloc)
    cur_page = cache.page_table[rows, page_idx]
    page = torch.where(need_new, new_page, cur_page)
    cache.page_table[rows, page_idx] = torch.where(ok & need_new, page, cur_page)
    tgt = torch.where(ok, page, 0).to(torch.int64)  # a skipped write: zeros to the zero page
    ok3 = ok[:, None, None]
    cache.k_codes[tgt, :, offset, :] = torch.where(ok3, k_codes, 0)
    cache.k_scale[tgt, :, 0, offset] = torch.where(ok[:, None], k_scale, 0.0)
    cache.v_codes[tgt, :, offset, :] = torch.where(ok3, v_codes, 0)
    cache.v_scale[tgt, :, 0, offset] = torch.where(ok[:, None], v_scale, 0.0)
    cache.lengths = i + ok.to(_I32)
    cache.free_top = cache.free_top - (need_new & can_alloc).sum(dtype=_I32)
    return cache


def paged_append(cache: PagedKVCache, slot: int, k: torch.Tensor,
                 v: torch.Tensor) -> PagedKVCache:
    """Quantize one token's K/V (H, D) and append it to ``slot``: the
    batched append with only that slot active (the same allocation and
    the same saturation rules)."""
    b = cache.lengths.shape[0]
    kq, ks = quantize_kv_rows(k)
    vq, vs = quantize_kv_rows(v)
    active = torch.zeros((b,), dtype=torch.bool, device=k.device)
    active[slot] = True
    lanes = lambda t: t[None].expand(b, *t.shape)
    return paged_append_batch(cache, lanes(kq), lanes(ks[:, 0]), lanes(vq), lanes(vs[:, 0]),
                              active)


def paged_insert_from_dense(
    cache: PagedKVCache,
    slot: int,
    k_codes: torch.Tensor,  # (H, S, D) int8: a slot's dense rows (prefill)
    k_scale: torch.Tensor,  # (H, S) f32
    v_codes: torch.Tensor,
    v_scale: torch.Tensor,
    length: Union[int, torch.Tensor],  # valid rows (<= S)
) -> PagedKVCache:
    """Page in a freshly prefilled dense cache view: the paged loop's
    admission. S must be ``max_pages * page_size`` and the slot empty
    (admission frees it first). ``ceil(length / page_size)`` pages come off
    the stack at once; if the stack runs out, the pages past it are
    dropped and ``lengths`` records only the rows stored."""
    ps, mp = cache.page_size, cache.max_pages
    h, s, d = k_codes.shape
    if s != mp * ps:
        raise ValueError(f"dense view has S={s}, the slot holds {mp} x {ps} rows")
    dev = cache.free_stack.device
    length = torch.as_tensor(length, dtype=_I32, device=dev)
    j = torch.arange(mp, device=dev)
    do = (j < _pages_used(length, ps)) & (j < cache.free_top)
    pages = cache.free_stack[torch.clamp(cache.free_top - 1 - j, min=0).to(torch.int64)]
    pages = torch.where(do, pages, 0)
    n_alloc = do.sum(dtype=_I32)
    cache.page_table[slot] = pages
    tgt = pages.to(torch.int64)  # pages that were not allocated: zeros to the zero page
    do4 = do[:, None, None, None]
    cache.k_codes[tgt] = torch.where(do4, k_codes.reshape(h, mp, ps, d).transpose(0, 1), 0)
    cache.v_codes[tgt] = torch.where(do4, v_codes.reshape(h, mp, ps, d).transpose(0, 1), 0)
    cache.k_scale[tgt] = torch.where(do4, k_scale.reshape(h, mp, 1, ps).transpose(0, 1), 0.0)
    cache.v_scale[tgt] = torch.where(do4, v_scale.reshape(h, mp, 1, ps).transpose(0, 1), 0.0)
    cache.lengths[slot] = torch.minimum(length, n_alloc * ps)
    cache.free_top = cache.free_top - n_alloc
    return cache


def paged_gather_dense(
    cache: PagedKVCache, slot: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``slot``'s logical (H, S, D) codes and (H, S) scales, K then V, and
    its length; S = max_pages * page_size. Unallocated tail pages read the
    zero page and lie past the length."""
    pages = cache.page_table[slot].to(torch.int64)

    def dense(codes, scale):
        c = codes[pages]  # (MP, H, page, D)
        sc = scale[pages]  # (MP, H, 1, page)
        mp, h, ps, d = c.shape
        return (c.transpose(0, 1).reshape(h, mp * ps, d),
                sc[:, :, 0, :].transpose(0, 1).reshape(h, mp * ps))

    kc, ks = dense(cache.k_codes, cache.k_scale)
    vc, vs = dense(cache.v_codes, cache.v_scale)
    return kc, ks, vc, vs, cache.lengths[slot]


def paged_hbm_bytes(cache: PagedKVCache) -> int:
    """Pool storage bytes: pages x page bytes, whatever the slot count."""
    return sum(t.numel() * t.element_size()
               for t in (cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale))
