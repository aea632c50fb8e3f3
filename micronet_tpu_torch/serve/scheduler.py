"""Continuous-batching scheduler over the batched decode step.

Counterpart of ``micronet_tpu/serve/scheduler.py``. Requests of
different lengths join mid-flight, finished requests leave, and their
slot is recycled for the next queued request:

- admission prefills the request alone (optionally in fixed-size chunks)
  and copies its cache into the batched cache at the free slot, or, with
  ``paged=True``, pages it into the shared pool;
- every step runs ``model.decode_batch`` (or ``decode_batch_paged``)
  over all slots; idle slots step too, on masked garbage, so the step's
  shapes never change;
- dense eviction is host-side bookkeeping (the slot's state is
  overwritten at the next admission); paged eviction returns the slot's
  pages to the pool at once.

Determinism contract: a request's tokens equal those of its isolated
``generate()`` / ``generate_sampled()`` run, whatever shares the batch.
For a W4 model on the card it holds with ``max_slots <= 128``: a decode
step's W4 matmuls run at M = ``max_slots`` in the same regime of
``ops/int4_matmul.py::int4_matmul_grouped_hl8`` as ``generate``'s at M = 1,
and within a regime a row's result does not depend on M. Past 128 slots the
loop decodes in the other regime (``_k3_regime``), and so does a chunked
prefill whose chunk (``prefill_chunk``) and prompt length lie on opposite
sides of 128 rows. The two regimes agree only within K3's tolerance, so the
logits then differ by rounding and a near tie may pick another token.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Union

import torch

from .._device import resolve_device
from ..quant.paged_kv import paged_free_slot, paged_insert_from_dense
from .sampling import position_generator, sample_token, sample_token_batch

__all__ = ["Request", "ServeLoop"]


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature == 0`` decodes greedily;
    otherwise tokens are sampled with temperature / top-k / top-p from
    generators keyed by (seed, absolute position)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # filled by the loop:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeLoop:
    """Admission/eviction scheduler over ``model.decode_batch`` slots.

    ``device`` defaults to CUDA (raising when no card is present) and
    must be the model's device. ``prefill_chunk > 0`` prefills prompts in
    chunks of that many tokens; pad rows of the last chunk land past the
    true length, and the slot's fill pointer is reset to the true length,
    so decode overwrites them.

    ``paged=True`` keeps the KV rows in a pool of ``num_pages`` pages of
    ``page_size`` rows per layer (default: the dense capacity plus the
    zero page) instead of ``max_slots * max_seq`` rows. Admission checks
    that the pool has the pages of the whole request (prompt plus decode
    growth) and otherwise puts it back at the head of the queue (counted
    in ``deferred``); decode appends pop pages for occupied slots only;
    eviction returns the pages. The check is made at admission time only: requests admitted one after
    another may together outgrow the pool, and a slot whose append was
    dropped is then finished early (truncated). The model must provide
    ``init_paged_cache`` and ``decode_batch_paged``. Token streams equal
    the dense loop's.

    For a W4 model on the card, tokens equal ``generate``'s (the module's
    contract) only up to 128 slots, and with a ``prefill_chunk`` only for
    prompts on its side of 128 rows: see the module's note."""

    def __init__(
        self,
        model,
        max_slots: int,
        *,
        paged: bool = False,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefill_chunk: int = 0,
        device: Union[str, torch.device, None] = None,
    ):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, loop on {dev}")
        self.model = model
        self.device = dev
        self.paged = paged
        self.prefill_chunk = prefill_chunk
        self.max_seq = model.cfg.max_seq
        if paged:
            self.page_size = page_size
            if num_pages is None:
                num_pages = 1 + max_slots * (self.max_seq // page_size)
            self.num_pages = num_pages
            self.caches = model.init_paged_cache(max_slots, page_size, num_pages)
            self.active = torch.zeros((max_slots,), dtype=torch.bool, device=dev)
        else:
            self.caches = model.init_cache_batch(max_slots)
        self.offsets = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self.host_offsets = [0] * max_slots  # mirror of ``offsets``
        self.next_tok = torch.zeros((max_slots, 1), dtype=torch.int64, device=dev)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self.deferred = 0  # admissions put back for want of pages
        # per-slot sampling parameters, on the host
        self.temps = [0.0] * max_slots
        self.topks = [0] * max_slots
        self.topps = [1.0] * max_slots
        self.seeds = [0] * max_slots

    # -- request lifecycle --------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self, slot: int, req: Request) -> bool:
        """Prefill ``req`` alone, then copy its cache, offset and first
        token into ``slot`` (overwriting all of the slot's state). In paged
        mode, a pool short of the request's pages puts it back at the head
        of the queue and returns False."""
        n = len(req.prompt)
        if self.paged:
            # the rows the request will append: its prompt and every output
            # token but the last, whose row is never written; capped at
            # max_seq, and at the whole pool, so a request bigger than the
            # pool is admitted once the pool is free (and then truncated)
            rows = min(n + max(req.max_new_tokens - 1, 0), self.max_seq)
            needed = min(-(-rows // self.page_size), self.num_pages - 1)
            if int(self.caches[0].free_top) < needed:
                self.queue.appendleft(req)
                self.deferred += 1
                return False
        prompt = torch.tensor(req.prompt, dtype=torch.int64, device=self.device)
        last_logits, single = self._prefill(prompt)
        first = sample_token(
            last_logits, position_generator(req.seed, n, self.device),
            req.temperature, req.top_k, req.top_p,
        )
        if self.paged:
            for pool, one in zip(self.caches, single):
                paged_free_slot(pool, slot)
                paged_insert_from_dense(pool, slot, one.k_codes, one.k_scale[..., 0],
                                        one.v_codes, one.v_scale[..., 0], n)
            self.active[slot] = True
        else:
            for full, one in zip(self.caches, single):
                full.k_codes[slot].copy_(one.k_codes)
                full.k_scale[slot].copy_(one.k_scale)
                full.v_codes[slot].copy_(one.v_codes)
                full.v_scale[slot].copy_(one.v_scale)
                # a chunked prefill appended pad rows: the fill pointer is
                # the true length, so decode overwrites them
                full.length[slot] = n if self.prefill_chunk else one.length
        self.offsets[slot] = n
        self.host_offsets[slot] = n
        self.next_tok[slot, 0] = first
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k
        self.topps[slot] = req.top_p
        self.seeds[slot] = req.seed
        req.output.append(int(first))
        self.slot_req[slot] = req
        self._maybe_finish(slot)
        return True

    def _prefill(self, prompt: torch.Tensor):
        """(last-position logits (V,), single-slot caches). With
        ``prefill_chunk = C`` the prompt is padded to a multiple of C and
        run through ceil(L/C) forwards of C tokens, unless the padding
        would overflow the cache."""
        length = int(prompt.shape[0])
        c = self.prefill_chunk
        if c and -(-length // c) * c <= self.max_seq:
            pad = (-length) % c
            toks = torch.nn.functional.pad(prompt, (0, pad))
            cache = self.model.init_cache()
            last = None
            for i in range(toks.shape[0] // c):
                logits, cache = self.model.forward(toks[i * c : (i + 1) * c], cache, i * c)
                if i == (length - 1) // c:
                    last = logits[(length - 1) % c]
            return last, cache
        logits, cache = self.model.forward(prompt, self.model.init_cache(), 0)
        return logits[-1], cache

    def _maybe_finish(self, slot: int, kv_len: Optional[int] = None) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        hit_eos = req.eos is not None and req.output and req.output[-1] == req.eos
        # capacity: a slot at offset >= max_seq cannot append another row
        full = self.host_offsets[slot] >= self.max_seq
        # paged: a fill pointer behind the offset means an append was
        # dropped (the pool ran out); decoding on would attend to an
        # incomplete cache, so the request ends here (truncated)
        pool_oom = self.paged and kv_len is not None and kv_len < self.host_offsets[slot]
        if len(req.output) >= req.max_new_tokens or hit_eos or full or pool_oom:
            req.done = True
            self.finished[req.rid] = req
            self.slot_req[slot] = None
            if self.paged:
                for pool in self.caches:
                    paged_free_slot(pool, slot)
                self.active[slot] = False

    # -- the loop -----------------------------------------------------------

    def step(self) -> None:
        """Admit queued requests into free slots, then one batched decode
        step for every slot."""
        for slot in self._free_slots():
            if not self.queue:
                break
            if not self._admit(slot, self.queue.popleft()):
                break  # the pool is short: later requests keep their turn
        if all(r is None for r in self.slot_req):
            return
        if self.paged:
            logits, self.caches = self.model.decode_batch_paged(
                self.next_tok, self.caches, self.offsets, self.active)
        else:
            step_fn = getattr(self.model, "decode_batch", None) or self.model.forward_batch
            logits, self.caches = step_fn(self.next_tok, self.caches, self.offsets)
        # the token produced from the input at position `off` sits at
        # position off + 1: its generator is keyed by that position
        toks = sample_token_batch(
            logits[:, 0, :], self.seeds, [o + 1 for o in self.host_offsets],
            self.temps, self.topks, self.topps,
        )
        self.offsets = self.offsets + 1
        self.host_offsets = [o + 1 for o in self.host_offsets]
        self.next_tok = toks[:, None]
        host_toks = toks.tolist()
        # the pool's fill pointers, read once per step
        host_lens = self.caches[0].lengths.tolist() if self.paged else None
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.output.append(host_toks[slot])
            self._maybe_finish(slot, None if host_lens is None else host_lens[slot])

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drive until every submitted request finishes (or max_steps)."""
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.finished
