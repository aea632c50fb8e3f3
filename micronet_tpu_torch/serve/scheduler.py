"""Continuous-batching scheduler over the batched decode step.

Counterpart of ``micronet_tpu/serve/scheduler.py`` (dense KV slots only).
Requests of different lengths join mid-flight, finished requests leave,
and their slot is recycled for the next queued request:

- admission prefills the request alone (optionally in fixed-size chunks)
  and copies its cache into the batched cache at the free slot;
- every step runs ``model.decode_batch`` over all slots; idle slots step
  too, on masked garbage, so the step's shapes never change;
- eviction is host-side bookkeeping; the slot's device state is fully
  overwritten at the next admission.

Determinism contract: a request's tokens equal those of its isolated
``generate()`` / ``generate_sampled()`` run, whatever shares the batch.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Union

import torch

from .._device import resolve_device
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
    so decode overwrites them."""

    def __init__(
        self,
        model,
        max_slots: int,
        *,
        paged: bool = False,
        prefill_chunk: int = 0,
        device: Union[str, torch.device, None] = None,
    ):
        if paged:
            raise NotImplementedError(
                "paged ServeLoop is not ported yet (ROADMAP.md, Queue 1, "
                "slice 3: paged serving, kernels K6/K7)"
            )
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, loop on {dev}")
        self.model = model
        self.device = dev
        self.prefill_chunk = prefill_chunk
        self.max_seq = model.cfg.max_seq
        self.caches = model.init_cache_batch(max_slots)
        self.offsets = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self.host_offsets = [0] * max_slots  # mirror of ``offsets``
        self.next_tok = torch.zeros((max_slots, 1), dtype=torch.int64, device=dev)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
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

    def _admit(self, slot: int, req: Request) -> None:
        """Prefill ``req`` alone, then copy its cache, offset and first
        token into ``slot`` (overwriting all of the slot's state)."""
        n = len(req.prompt)
        prompt = torch.tensor(req.prompt, dtype=torch.int64, device=self.device)
        last_logits, single = self._prefill(prompt)
        first = sample_token(
            last_logits, position_generator(req.seed, n, self.device),
            req.temperature, req.top_k, req.top_p,
        )
        for full, one in zip(self.caches, single):
            full.k_codes[slot].copy_(one.k_codes)
            full.k_scale[slot].copy_(one.k_scale)
            full.v_codes[slot].copy_(one.v_codes)
            full.v_scale[slot].copy_(one.v_scale)
            # a chunked prefill appended pad rows: the fill pointer is the
            # true length, so decode overwrites them
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

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        hit_eos = req.eos is not None and req.output and req.output[-1] == req.eos
        # capacity: a slot at offset >= max_seq cannot append another row
        full = self.host_offsets[slot] >= self.max_seq
        if len(req.output) >= req.max_new_tokens or hit_eos or full:
            req.done = True
            self.finished[req.rid] = req
            self.slot_req[slot] = None

    # -- the loop -----------------------------------------------------------

    def step(self) -> None:
        """Admit queued requests into free slots, then one batched decode
        step for every slot."""
        for slot in self._free_slots():
            if not self.queue:
                break
            self._admit(slot, self.queue.popleft())
        if all(r is None for r in self.slot_req):
            return
        logits, self.caches = self.model.decode_batch(
            self.next_tok, self.caches, self.offsets
        )
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
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.output.append(host_toks[slot])
            self._maybe_finish(slot)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drive until every submitted request finishes (or max_steps)."""
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.finished
