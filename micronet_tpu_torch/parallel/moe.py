"""Mixture-of-Experts, on one device or expert-parallel: the counterpart of
``micronet_tpu/parallel/moe.py``.

GShard-style routing with static capacity: the router's choices become a
one-hot dispatch tensor ``D (T, E, C)`` built with a cumsum slot
assignment, and the gather to expert slots and the combine back are
einsums against ``D``. Tokens past an expert's capacity are dropped
(output 0; the residual connection carries them). :func:`quantize_moe`
stores the expert matrices as int8 codes with per-(expert, column)
scales; the experts then run on the weights dequantized to f32, as the
JAX package's XLA path runs them.

Where torch differs from JAX and this module keeps JAX's result:

- ``jax.nn.one_hot`` gives a zero row for an index outside [0, n); the
  dispatch relies on it for dropped (slot >= capacity) and unrouted
  (slot -1) tokens, and ``torch.nn.functional.one_hot`` raises on both,
  so one-hots here are comparisons with an ``arange``;
- ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk``
  promises no order among ties, so the top k here come from a stable
  descending sort;
- ``jax.nn.gelu`` is the tanh form by default; torch's ``F.gelu`` the
  erf form unless asked.

Expert parallelism over an ``expert`` axis (a 1-D mesh of
``parallel.sharding.axis_mesh``), one process a rank:

- :func:`moe_apply_ep`: each rank holds E/ep experts, every rank routes
  the whole replicated x identically (capacity from the global T), runs
  its experts' slots and the ranks' parts are summed (``distributed.
  psum``);
- :func:`moe_apply_ep_a2a`: the tokens are cut over the axis, each rank
  routes its own with a capacity per shard, and two ``all_to_all``
  exchanges carry the expert slots to their owners and back, so its
  oracle is :func:`moe_apply` on each token shard.

Both take the global x and give the global result on every rank, as the
JAX package's caller sees them. The expert tensors are the whole E
(every rank then takes its slice, and the backward gathers the slices'
gradients, so every rank holds JAX's whole gradient) or already this
rank's E/ep (``MoEMLP.use_ep`` keeps them so; their gradients stay local).
Every rank computes the same loss from the result, so the replicated
router and x sum their gradients over the axis (``distributed.sum_grad``):
the gradients equal the dense ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.int4_matmul import symmetric_rtn

__all__ = ["MoEParams", "init_moe", "quantize_moe", "moe_apply", "moe_apply_ep",
           "moe_apply_ep_a2a", "load_balance_loss"]


@dataclasses.dataclass
class MoEParams:
    """MoE MLP parameters. ``w_up``/``w_down`` are float ``(E, dim, mlp)``
    / ``(E, mlp, dim)``, or int8 codes with ``up_scale``/``down_scale``
    ``(E, 1, cols)`` after :func:`quantize_moe`."""

    router: torch.Tensor  # (dim, E) f32
    w_up: torch.Tensor  # (E, dim, mlp)
    w_down: torch.Tensor  # (E, mlp, dim)
    up_scale: Optional[torch.Tensor] = None
    down_scale: Optional[torch.Tensor] = None

    def up(self) -> torch.Tensor:
        if self.up_scale is None:
            return self.w_up
        return self.w_up.to(self.up_scale.dtype) * self.up_scale

    def down(self) -> torch.Tensor:
        if self.down_scale is None:
            return self.w_down
        return self.w_down.to(self.down_scale.dtype) * self.down_scale


def init_moe(dim: int, mlp_dim: int, n_experts: int, *,
             device: Union[str, torch.device, None] = None,
             generator: Optional[torch.Generator] = None) -> MoEParams:
    """Random parameters from ``generator``, on ``device`` (None = CUDA):
    router N(0, 0.02^2), experts N(0, 1/fan_in)."""
    dev = resolve_device(device)
    randn = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    return MoEParams(
        router=randn(dim, n_experts) * 0.02,
        w_up=randn(n_experts, dim, mlp_dim) / math.sqrt(dim),
        w_down=randn(n_experts, mlp_dim, dim) / math.sqrt(mlp_dim),
    )


def quantize_moe(params: MoEParams) -> MoEParams:
    """Int8 weight-only experts: symmetric RTN per (expert, column), the
    weight-only kit's rounding (:func:`..ops.int4_matmul.symmetric_rtn`
    at qmax 127). The router stays float: it decides which expert runs."""
    up_c, up_s = symmetric_rtn(params.w_up, 127.0, axis=1)
    dn_c, dn_s = symmetric_rtn(params.w_down, 127.0, axis=1)
    return MoEParams(router=params.router, w_up=up_c, w_down=dn_c, up_scale=up_s,
                     down_scale=dn_s)


def _capacity(n_tokens: int, n_experts: int, capacity_factor: float, top_k: int = 1) -> int:
    return max(1, int(math.ceil(capacity_factor * top_k * n_tokens / n_experts)))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row where ``idx`` lies outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _dispatch(logits: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 dispatch: router logits (T, E) -> (gate (T,), D (T, E, C)).

    ``D[t, e, c] = 1`` iff token t is the c-th token routed to expert e
    and c < capacity; slots follow the token order (a cumsum)."""
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(torch.argmax(logits, dim=-1), logits.shape[-1], logits.dtype)
    gate = torch.sum(probs * onehot, dim=-1)
    pos = torch.cumsum(onehot, dim=0).to(torch.int32) - 1
    # slot >= capacity (dropped) and -1 (not routed here) give zero rows
    return gate, _one_hot(pos, capacity, logits.dtype) * onehot[..., None]


def _top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (T, k) of the k largest logits per row, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


def _dispatch_topk(logits: torch.Tensor, capacity: int,
                   top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard top-k dispatch: logits (T, E) -> (dispatch D (T, E, C) in
    {0, 1}, combine W (T, E, C)). Gates are the chosen experts' router
    probabilities renormalized over the k choices; slots are choice-major
    (every token's first choice queues before any token's second), so a
    capacity squeeze drops second choices first."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    idx = _top_k(logits, top_k)
    onehots = [_one_hot(idx[:, j], e, logits.dtype) for j in range(top_k)]
    gates = [torch.sum(probs * oh, dim=-1) for oh in onehots]
    denom = sum(gates) + 1e-9
    gates = [g / denom for g in gates]
    dmat = torch.zeros((t, e, capacity), dtype=logits.dtype, device=logits.device)
    comb = torch.zeros_like(dmat)
    base = torch.zeros((e,), dtype=torch.int32, device=logits.device)  # slots taken so far
    for j in range(top_k):
        oh = onehots[j]
        pos = torch.cumsum(oh, dim=0).to(torch.int32) - 1 + base[None, :]
        d_j = _one_hot(pos, capacity, logits.dtype) * oh[..., None]
        dmat = dmat + d_j
        comb = comb + d_j * gates[j][:, None, None]
        base = base + torch.sum(oh, dim=0).to(torch.int32)
    return dmat, comb


def _expert_mlp(xe: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """(E, C, dim) expert slots through each expert's MLP."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", xe, w_up), approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_down)


def moe_apply(params: MoEParams, x: torch.Tensor, capacity_factor: float = 1.25,
              top_k: int = 1) -> torch.Tensor:
    """Single-device top-k MoE forward: x (T, dim) -> (T, dim). ``top_k=1``
    is Switch routing; ``top_k=2`` GShard's (renormalized gates,
    choice-major capacity)."""
    n_experts = params.router.shape[-1]
    cap = _capacity(x.shape[0], n_experts, capacity_factor, top_k)
    logits = x @ params.router
    if top_k == 1:
        gate, dmat = _dispatch(logits, cap)
        comb = dmat * gate[:, None, None]
    else:
        dmat, comb = _dispatch_topk(logits, cap, top_k)
    xe = torch.einsum("td,tec->ecd", x, dmat)
    y = _expert_mlp(xe, params.up(), params.down())
    return torch.einsum("ecd,tec->td", y, comb)


def _local_experts(params: MoEParams, group, ep: int):
    """This rank's (up, down) expert weights, dequantized: its slice of the
    whole E (through ``distributed.split``, whose backward gathers the
    slices' gradients) or the E/ep it already holds."""
    from .distributed import split

    n_experts = params.router.shape[-1]
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not divide over {ep} ranks")
    e_local = n_experts // ep
    whole = params.w_up.shape[0] == n_experts
    if not whole and params.w_up.shape[0] != e_local:
        raise ValueError(f"expert weights of {params.w_up.shape[0]} experts: neither the "
                         f"{n_experts} nor this rank's {e_local}")

    def local(w, s):
        if whole:
            w = split(w, 0, group)
            s = None if s is None else split(s, 0, group)
        return w if s is None else w.to(s.dtype) * s

    return local(params.w_up, params.up_scale), local(params.w_down, params.down_scale)


def _axis(mesh, axis: str):
    from .sharding import axis_rank, axis_size

    return mesh.get_group(axis), axis_size(mesh, axis), axis_rank(mesh, axis)


def moe_apply_ep(params: MoEParams, x: torch.Tensor, mesh, axis: str = "expert",
                 capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert-parallel top-1 forward over ``mesh``'s ``axis``: each rank
    runs its E/ep experts' slots of the replicated x (T, dim), the parts
    are summed. Semantics, routing and capacity are :func:`moe_apply`'s;
    the sum runs in another order, so values agree to f32 rounding.
    Differentiable (module docstring)."""
    from .distributed import psum, sum_grad

    group, ep, k = _axis(mesh, axis)
    n_experts = params.router.shape[-1]
    up, down = _local_experts(params, group, ep)
    e_local = n_experts // ep
    cap = _capacity(x.shape[0], n_experts, capacity_factor)
    x, router = sum_grad(x, group), sum_grad(params.router, group)
    logits = x @ router  # replicated: every rank routes identically
    gate, dmat = _dispatch(logits, cap)
    d_local = dmat[:, k * e_local:(k + 1) * e_local]
    xe = torch.einsum("td,tec->ecd", x, d_local)
    y = _expert_mlp(xe, up, down)
    out = torch.einsum("ecd,tec->td", y, d_local) * gate[:, None]
    return psum(out, group)


def moe_apply_ep_a2a(params: MoEParams, x: torch.Tensor, mesh, axis: str = "expert",
                     capacity_factor: float = 1.25, top_k: int = 2) -> torch.Tensor:
    """Expert parallelism with GShard's all-to-all token exchange: rank r
    routes rows [r T/ep, (r + 1) T/ep) of x (T, dim) with a capacity of
    its own, sends each expert's slots to the expert's owner
    (``distributed.all_to_all``), runs its experts on every shard's slots
    and sends the results back; the ranks' rows are gathered. Equals
    :func:`moe_apply` on each token shard. Differentiable (module
    docstring)."""
    from .distributed import all_to_all, gather, split, sum_grad

    group, ep, _ = _axis(mesh, axis)
    n_experts = params.router.shape[-1]
    if x.shape[0] % ep:
        raise ValueError(f"{x.shape[0]} tokens do not divide over {ep} ranks")
    up, down = _local_experts(params, group, ep)
    e_local = n_experts // ep
    t_local = x.shape[0] // ep
    cap = _capacity(t_local, n_experts, capacity_factor, top_k)
    dim = x.shape[-1]
    x_l, router = split(x, 0, group), sum_grad(params.router, group)
    logits = x_l @ router  # (T_l, E): each shard routes its own tokens
    if top_k == 1:
        gate, dmat = _dispatch(logits, cap)
        comb = dmat * gate[:, None, None]
    else:
        dmat, comb = _dispatch_topk(logits, cap, top_k)
    xe = torch.einsum("td,tec->ecd", x_l, dmat).reshape(ep, e_local, cap, dim)
    # dim 0: the owner's rank on the way out, the source shard on the way in
    xr = all_to_all(xe, group).transpose(0, 1).reshape(e_local, ep * cap, dim)
    y = _expert_mlp(xr, up, down)
    y = y.reshape(e_local, ep, cap, dim).transpose(0, 1)
    yr = all_to_all(y, group).reshape(n_experts, cap, dim)
    return gather(torch.einsum("ecd,tec->td", yr, comb), 0, group)


def load_balance_loss(logits: torch.Tensor) -> torch.Tensor:
    """GShard/Switch auxiliary load-balancing loss ``E * sum_e f_e * P_e``:
    ``f_e`` the fraction of tokens top-1-routed to expert e, ``P_e`` the
    mean router probability."""
    n_experts = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(torch.argmax(logits, dim=-1), n_experts, logits.dtype)
    return n_experts * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
