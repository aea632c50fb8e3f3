"""Pipeline parallelism (GPipe-style) over a ``stage`` axis: the counterpart
of ``micronet_tpu/parallel/pipeline.py``.

The model is S sequential stages with one parameter structure; rank i of
the axis (a 1-D mesh of ``parallel.sharding.axis_mesh``, one process a
rank) runs stage i. A loop of ``n_micro + S - 1`` ticks drives the classic
schedule: at every tick each rank applies its stage to the activation it
received at the tick before (rank 0 to microbatch t while there is one)
and passes the result on (``distributed.ppermute``, a batched ``isend``/
``irecv`` pair, to the next rank). The last stage emits microbatch
t - (S - 1) at tick t; its outputs are handed to every rank
(``distributed.hand_out``), so every rank returns them. The bubble share
is (S - 1) / (n_micro + S - 1).

Backward is a plain ``loss.backward()`` on every rank: each exchange's
backward is the reverse exchange. Autograd runs a backward only where a
result reaches the loss, so the schedule keeps every rank's graph the same
(JAX's ``jnp.where`` selects, not Python branches): rank 0's input is
``torch.where(first, microbatch, received)``, every rank computes its
stage on every tick (bubble ticks on zeros, as in JAX), and every rank's
tick outputs enter the handed-out result, with a zero gradient off the
last stage. Every rank therefore runs every reverse exchange, in the
same order.

Stage functions take their parameters as a dict of tensors; a module
stage goes through ``torch.func.functional_call`` (the dry run's
``graft_entry._stage_fn``). Stacked parameters are dicts of tensors with a
leading stage dim: the whole S (every rank then takes its row through
``distributed.split``, whose backward gathers the rows' gradients, so
every rank holds JAX's whole gradient) or only this rank's row (leading
dim 1; its gradient stays local): each rank keeps only its stage's slice
either way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["pipeline_apply", "pipeline_apply_stateful", "stack_stage_params"]


def stack_stage_params(params_list):
    """Stack S per-stage parameter dicts (one structure) into one dict with
    a leading stage dim."""
    keys = list(params_list[0])
    for p in params_list[1:]:
        if list(p) != keys:
            raise ValueError("every stage must have the same parameter names")
    return {k: torch.stack([p[k] for p in params_list]) for k in keys}


def _stage_rows(stacked: Dict[str, torch.Tensor], s: int, group) -> Tuple[Dict, bool]:
    """This rank's stage row of each stacked tensor, and whether they were
    the whole stack."""
    from .distributed import split

    lead = {t.shape[0] for t in stacked.values()}
    if len(lead) > 1 or (lead and lead.pop() not in (s, 1)):
        raise ValueError(f"stacked tensors need a leading dim of {s} stages (or 1, this "
                         f"rank's): got {sorted({t.shape[0] for t in stacked.values()})}")
    if all(t.shape[0] == s for t in stacked.values()):
        return {k: split(t, 0, group)[0] for k, t in stacked.items()}, True
    return {k: t[0] for k, t in stacked.items()}, False


def _schedule(stage: Callable, x: torch.Tensor, mesh, axis: str, state: Optional[Dict]):
    """The tick loop of both forms: returns (this rank's output of each
    tick, the stage state after its real microbatches)."""
    from .distributed import ppermute, sum_grad
    from .sharding import axis_rank, axis_size

    s, idx = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    n_micro = x.shape[0]
    x = sum_grad(x, group)  # only rank 0 reads it: the others add zeros
    first = torch.tensor(idx == 0, device=x.device)
    nxt = list(range(1, s)) + [0]  # the ring, as JAX's perm
    recv = torch.zeros_like(x[0])
    outs = []
    for t in range(n_micro + s - 1):
        x_in = x[min(t, n_micro - 1)]
        x0 = (1.0 if t < n_micro else 0.0) * x_in
        h_in = torch.where(first, x0, recv)
        if state is None:
            h_out = stage(h_in)
        else:
            # the stage may write its state in place: it gets a copy, kept
            # only on a real microbatch (rank idx holds microbatch t - idx)
            h_out, new = stage({k: v.clone() for k, v in state.items()}, h_in)
            if 0 <= t - idx < n_micro:
                state = {k: v.detach() for k, v in new.items()}
        outs.append(h_out)
        if t < n_micro + s - 2:  # the last tick's hand-on would reach no one
            recv = ppermute(h_out, nxt, group)
    return outs, state


def _emit(outs, mesh, axis: str) -> torch.Tensor:
    """The last stage's outputs for ticks [S-1, S-1+n_micro), stacked, on
    every rank."""
    from .distributed import hand_out
    from .sharding import axis_size

    s = axis_size(mesh, axis)
    return hand_out(torch.stack(outs[s - 1:]), s - 1, mesh.get_group(axis))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Dict[str, torch.Tensor], x: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(stage_params, h) -> h`` as an S-stage pipeline over
    ``mesh``'s ``axis``. ``x`` is (n_micro, micro_batch, ...); the
    activation keeps its shape through every stage. Returns the last
    stage's outputs (n_micro, micro_batch, ...) on every rank: the fold
    ``for stage: h = stage_fn(p, h)`` of each microbatch, with only the
    schedule parallel. Differentiable end to end."""
    from .sharding import axis_size

    s = axis_size(mesh, axis)
    params, _ = _stage_rows(stacked_params, s, mesh.get_group(axis))
    outs, _ = _schedule(lambda h: stage_fn(params, h), x, mesh, axis, None)
    return _emit(outs, mesh, axis)


def pipeline_apply_stateful(stage_fn: Callable[[Any, Any, torch.Tensor], tuple],
                            stacked_params: Dict[str, torch.Tensor],
                            stacked_state: Dict[str, torch.Tensor], x: torch.Tensor, mesh,
                            axis: str = "stage"):
    """Pipeline with per-stage mutable state (a quantized stage's
    observers, BN running statistics, qparams):
    ``stage_fn(stage_params, stage_state, h) -> (h_out, stage_state')``.

    A stage's state moves on only with its real microbatches: on the
    warm-up and drain ticks the stage runs on bubble zeros and that update
    is dropped, so observers never see them. Returns ``(outputs,
    new_stacked_state)``; the outputs equal the sequential fold ``for mb:
    for stage: h, st = stage_fn(p, st, h)`` (each stage sees its
    microbatches in order, so observer trajectories match too), on every
    rank. The state comes back in the form it was given: the whole stack
    (gathered from the ranks) or this rank's row. Differentiable in the
    parameters; the state carries no gradient."""
    from .distributed import gather
    from .sharding import axis_size

    s = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    params, _ = _stage_rows(stacked_params, s, group)
    with torch.no_grad():
        state, whole = _stage_rows({k: v.detach() for k, v in stacked_state.items()}, s, group)
    outs, state = _schedule(lambda st, h: stage_fn(params, st, h), x, mesh, axis, state)
    with torch.no_grad():
        new = {k: gather(v[None].contiguous(), 0, group) if whole else v[None]
               for k, v in state.items()}
    return _emit(outs, mesh, axis), new
