"""Token sampling for the serving loop: temperature / top-k / top-p.

Counterpart of ``micronet_tpu/serve/sampling.py``. ``temperature == 0``
means greedy (argmax). The random numbers for the token at absolute
position ``p`` of a request come from a ``torch.Generator`` seeded from
(request seed, p) alone (:func:`position_generator`, in place of JAX's
``fold_in(PRNGKey(seed), p)``), never from the batch layout, so a request
samples the same tokens whether it runs alone or shares the batch. The
two frameworks draw different numbers from the same seed: sampled tokens
are compared within the port, greedy ones against JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "position_generator",
    "sample_token",
    "sample_token_batch",
    "generate_sampled",
]

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64 finalizer: neighbouring (seed, position) pairs give
    unrelated generator seeds."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def position_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator for the token at absolute ``position`` of a request
    with ``seed``: a function of (seed, position) only."""
    s = _mix64(_mix64(seed & _MASK64) ^ (position & _MASK64)) >> 1  # 63 bits
    return torch.Generator(device=device).manual_seed(s)


def sample_token(
    logits: torch.Tensor,  # (V,)
    generator: torch.Generator,
    temperature: float,
    top_k: int,
    top_p: float,
) -> torch.Tensor:
    """One token id (0-dim int64 tensor on the logits' device)."""
    if temperature <= 0:
        return torch.argmax(logits)
    v = logits.shape[-1]
    scaled = logits.to(torch.float32) / max(temperature, 1e-6)
    desc = torch.sort(scaled, descending=True).values
    # top-k: logits strictly below the k-th largest are cut; k <= 0 or
    # k >= V keeps everything
    k = min(max(top_k, 0), v)
    kth = desc[k - 1] if k > 0 else desc[v - 1]
    keep = scaled >= kth
    # top-p (nucleus): the smallest prefix of the descending list whose
    # mass reaches top_p; the first element crossing it is included
    probs_desc = torch.softmax(desc, dim=-1)
    included = (torch.cumsum(probs_desc, dim=-1) - probs_desc) < top_p
    thr = torch.min(torch.where(included, desc, torch.inf))
    keep = keep & (scaled >= thr)
    masked = torch.where(keep, scaled, -torch.inf)
    # Gumbel-max draw of categorical(softmax(masked))
    u = torch.rand(v, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(masked - torch.log(-torch.log(u)))


def sample_token_batch(
    logits: torch.Tensor,  # (B, V)
    seeds: Sequence[int],
    positions: Sequence[int],
    temperature: Sequence[float],
    top_k: Sequence[int],
    top_p: Sequence[float],
) -> torch.Tensor:
    """Per-slot sampling for the continuous batch: greedy rows take one
    batched argmax, sampled rows draw from their own (seed, position)
    generator. Returns (B,) int64 on the logits' device."""
    toks = torch.argmax(logits, dim=-1)
    for i, t in enumerate(temperature):
        if t > 0:
            g = position_generator(seeds[i], positions[i], logits.device)
            toks[i] = sample_token(logits[i], g, t, top_k[i], top_p[i])
    return toks


def generate_sampled(
    model,
    prompt: torch.Tensor,  # (T,)
    steps: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
) -> torch.Tensor:
    """Isolated sampled decode of ``steps`` tokens after ``prompt``: the
    single-request oracle for the continuous-batching loop."""
    dev = prompt.device
    logits, caches = model.forward(prompt, model.init_cache(), 0)
    pos = int(prompt.shape[0])
    tok = sample_token(logits[-1], position_generator(seed, pos, dev),
                       temperature, top_k, top_p)
    out = [tok]
    for _ in range(steps - 1):
        logits, caches = model.forward(tok[None], caches, pos)
        pos += 1
        tok = sample_token(logits[-1], position_generator(seed, pos, dev),
                           temperature, top_k, top_p)
        out.append(tok)
    return torch.stack(out)
