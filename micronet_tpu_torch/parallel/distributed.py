"""Data parallelism over ``torch.distributed``: the counterpart of
``micronet_tpu/parallel/distributed.py``.

The JAX package runs one process that owns every device: XLA partitions
each global reduction of a step over the mesh and inserts the psum, pmin
and pmax itself (GSPMD), or ``shard_map`` runs them where the code names
an ``axis_name``. The port runs one process per card (NCCL on the card,
gloo on the CPU), so each reduction XLA inserted is written here and
called where the port computes it:

- :func:`initialize` brings the process group up (a no-op in a single
  process, as the JAX version is) and makes the rank's card current
  before any kernel is built or launched;
- :func:`batch_reduction` is the counterpart of the observers'
  ``axis_name``: inside it a batch statistic (observer ranges, the
  percentile, the entropy histogram, BN batch moments) is global over
  the given process group; outside it, or with ``None`` (a replicated
  batch, which every rank holds whole), it reduces over nothing;
- the collectives the layers call: :func:`all_reduce_sum` (autograd
  flows through it: its backward all-reduces the gradient), the in-place
  min/max/sum of statistics (:func:`all_reduce_`), :func:`gather`
  (concatenation along a dim, whose backward takes this rank's slice, no
  communication: under tensor parallelism every model rank computes the
  same downstream loss, so the summing backward of
  ``torch.distributed.nn.functional.all_gather`` would give tp times the
  gradient), its inverse :func:`split` (a grouped layer's input channels:
  the ranks consume different slices, so its backward gathers their
  gradients, and the whole gradient is again on every rank),
  :func:`sum_grad` (the whole input of a layer whose ranks compute
  different out channels from it: its backward sums their gradients) and
  :func:`batch_moments` (BN's mean and variance over the global batch);
- :func:`dp_shard_map_step`, the explicit-collective step: local
  statistics, gradients averaged, then the state reduced by name.

Gloo has no ``ReduceOp.AVG``: every mean is a SUM and a division. No
collective falls back to a local result: a reduction asked for over a
group runs over it, and fails if the group is not there.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["initialize", "dp_shard_map_step", "batch_reduction", "batch_group",
           "all_reduce_sum", "all_reduce_", "gather", "split", "sum_grad", "batch_moments"]

Groups = Union[None, dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device=None) -> bool:
    """Bring up the process group (no-op in a single process).

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); a
    process that has neither arguments nor that environment returns
    False at once, so driver scripts can call it unconditionally.
    ``device`` None means CUDA: the rank's card (``LOCAL_RANK``, else the
    rank modulo the cards) is made current first, then NCCL comes up;
    ``device="cpu"`` takes gloo. Returns True once the group is up."""
    from .._device import resolve_device

    if dist.is_initialized():
        return True
    env_world = os.environ.get("WORLD_SIZE")
    if init_method is None and world_size in (None, 1) and env_world is None:
        return False
    world = int(world_size if world_size is not None else env_world or 1)
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://", world_size=world, rank=rank)
    return True


# ------------------------------------------------------------ the batch group

_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group", default=None)


@contextlib.contextmanager
def batch_reduction(group: Optional[dist.ProcessGroup]):
    """Batch statistics computed inside are global over ``group`` (the
    data axis whose ranks each hold a slice of the batch); ``None`` means
    the batch is whole on this rank and nothing reduces."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group() -> Optional[dist.ProcessGroup]:
    """The group of the enclosing :func:`batch_reduction`, or None."""
    return _BATCH_GROUP.get()


def groups_of(group: Groups) -> Tuple[dist.ProcessGroup, ...]:
    """``None``, one group or several as a tuple (an observer may reduce
    over the data group and the model group, as an ``axis_name`` may name
    two mesh axes)."""
    if group is None:
        return ()
    if isinstance(group, dist.ProcessGroup):
        return (group,)
    return tuple(g for g in group if g is not None)


# ------------------------------------------------------------ collectives

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable: each rank's loss
    depends on the sum, so the gradient reaching a rank's ``x`` is the sum
    of every rank's gradient of the sum."""
    return _AllReduceSum.apply(x, group)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@torch.no_grad()
def all_reduce_(x: torch.Tensor, op: str, group: Groups) -> torch.Tensor:
    """``x`` reduced (``"sum"``, ``"min"``, ``"max"``) over each group in
    turn, as a new tensor (no gradient: statistics)."""
    out = x.detach().contiguous().clone()
    for g in groups_of(group):
        dist.all_reduce(out, op=_OPS[op], group=g)
    return out


def _gather_parts(x: torch.Tensor, group: dist.ProcessGroup):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * x.shape[dim]
        return torch.cat(_gather_parts(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None, None


def gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    (equal shapes). Its backward takes this rank's slice of the gradient:
    every rank computes the same function of the whole, so each already
    holds the whole gradient (a summing backward would count it once per
    rank)."""
    return _Gather.apply(x, dim, group)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grad(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group`` in the
    backward: the input of a layer whose ranks each compute their slice of
    the out channels from the whole input, so each rank's gradient of it
    is the part through its own channels."""
    return _SumGrad.apply(x, group)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        k = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * k, k)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_gather_parts(grad, ctx.group), ctx.dim), None, None


def split(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's slice of ``x`` (which every rank holds whole) along
    ``dim``, :func:`gather`'s inverse: each rank consumes another slice,
    so its backward gathers the ranks' slice gradients into the whole
    gradient, which every rank then holds."""
    return _Split.apply(x, dim, group)


@torch.no_grad()
def gather_flat(x: torch.Tensor, group: Groups) -> torch.Tensor:
    """Every rank's ``x`` flattened and concatenated (no gradient)."""
    out = x.reshape(-1)
    for g in groups_of(group):
        out = torch.cat(_gather_parts(out, g))
    return out


def batch_moments(x: torch.Tensor, dims: Tuple[int, ...], n_local: Optional[int] = None):
    """``(mean, biased variance, count)`` of ``x`` over ``dims`` in f32,
    global over :func:`batch_group` (whose ranks hold equal slices of the
    batch). The global mean is taken first, then the global sum of
    squared deviations from it, each through :func:`all_reduce_sum`, so
    the gradient flows through the global moments as it does under GSPMD:
    each rank's squared deviations about the global mean are its own
    variance plus its mean's offset, ``var_r + (mean_r - mean)^2``. In one
    rank's world the offset is 0 and the weights 1, so the moments equal
    the single-process ones bit for bit."""
    mean = torch.mean(x, dim=dims, dtype=torch.float32)
    var = torch.var(x.to(torch.float32), dim=dims, unbiased=False)
    if n_local is None:
        n_local = 1
        for d in dims:
            n_local *= x.shape[d]
    group = batch_group()
    if group is None:
        return mean, var, n_local
    n = n_local * dist.get_world_size(group)
    w = n_local / n
    g_mean = all_reduce_sum(mean * w, group)
    g_var = all_reduce_sum((var + torch.square(mean - g_mean)) * w, group)
    return g_mean, g_var, n


# ------------------------------------------------------------ the explicit step

def _mean_(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    return all_reduce_(t, "sum", group) / dist.get_world_size(group)


@torch.no_grad()
def _reduce_state(model: torch.nn.Module, group: dist.ProcessGroup) -> None:
    """The JAX step's ``reduce_state``: ``min_val`` by MIN, ``max_val`` and
    ``ent_absmax`` by MAX; ``ent_counts`` moved from the rank's own grid
    onto the merged (MAX) one before the mean, else a narrow rank's mass
    would be read at global/local times its place; every other float by
    its mean; integers and flags stay."""
    from ..quant.observers import _rescale_counts

    for m in model.modules():
        local_max = getattr(m, "ent_absmax", None)
        for name, buf in list(m.named_buffers(recurse=False)):
            if buf is None or not buf.is_floating_point():
                continue
            if name == "min_val":
                new = all_reduce_(buf, "min", group)
            elif name in ("max_val", "ent_absmax"):
                new = all_reduce_(buf, "max", group)
            elif name == "ent_counts":
                global_max = all_reduce_(local_max, "max", group)
                ratio = torch.where(global_max > 0,
                                    local_max / torch.clamp_min(global_max, 1e-30),
                                    torch.ones_like(global_max))
                rescaled = torch.where(ratio >= 1.0 - 1e-12, buf, _rescale_counts(buf, ratio))
                new = _mean_(rescaled, group)
            else:
                new = _mean_(buf, group)
            setattr(m, name, new)


def dp_shard_map_step(model: torch.nn.Module, mesh, loss_of_logits: Callable, *,
                      axis: str = "data"):
    """An explicit-collective data-parallel step over ``mesh``'s ``axis``:
    ``step(x, y) -> (loss, grads)``. ``x`` and ``y`` are the global batch;
    each rank runs the model on its rows (``shard_batch``) with its
    statistics local (no :func:`batch_reduction`), the gradients are
    averaged into each parameter's ``.grad`` (``grads`` maps the
    parameter names to them), the loss is averaged, then the state is
    reduced by name (:func:`_reduce_state`). As in the JAX package, the
    mean of the ranks' updated statistics equals the update from pooled
    statistics only approximately: that is this step's contract."""
    from .sharding import shard_batch

    group = mesh.get_group(axis)

    def step(x: torch.Tensor, y: torch.Tensor):
        xs, ys = shard_batch(x, mesh, axis), shard_batch(y, mesh, axis)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with batch_reduction(None):
            loss = loss_of_logits(model(xs), ys)
        loss.backward()
        grads = {}
        for name, p in params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = grads[name] = _mean_(g, group)
        _reduce_state(model, group)
        return _mean_(loss.detach(), group), grads

    return step
