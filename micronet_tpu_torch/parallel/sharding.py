"""Data and tensor (channel) parallelism over a device mesh: the
counterpart of ``micronet_tpu/parallel/sharding.py``.

The JAX package lays the state out on a ``(data, model)`` mesh with
``device_put`` and lets GSPMD partition the step. The port runs one
process per card, so a mesh is a ``torch.distributed`` ``DeviceMesh``
with dims ``("data", "model")`` over the process group, and each rank
keeps only what is its own:

- **data**: the batch's rows are split over the ``data`` axis
  (:func:`shard_batch`); the statistics a step writes are reduced over it
  where the port computes them (``parallel.distributed``);
- **model**: each layer whose out-channel axis divides by the ``model``
  axis keeps its slice of the out channels: the kernel, the bias, BN's
  vectors and running statistics, the per-channel quant state and, once
  the optimizer is sharded, Adam's moments. The axis is taken from the
  module, never from a shape (:func:`channel_sharding_for`). Such a layer
  computes its local out channels and gathers them along the channel
  axis (``parallel.distributed.gather``, whose backward takes the local
  slice), so every layer after it sees the whole activation. A grouped
  layer whose groups divide by the axis takes the input channels of its
  own groups; its activation quantizer then sees a slice, and reduces
  its range over the model group too, as does a per-tensor weight
  quantizer over a sliced kernel. Everything else is replicated: a
  DoReFa layer (its weight is normalised by the whole kernel's max, with
  a gradient through it), a grouped transposed conv, the integer engine's
  transposed conv, scalars.

The channel-parallel layer is the layer itself with two hooks (split the
input where it is grouped, else sum its gradient over the model ranks;
gather the output), so module paths and
``state_dict`` keys stay those of the unsharded model; :func:`unsharded`
gathers the whole state back for a checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .distributed import _gather_parts, gather, split, sum_grad

__all__ = ["make_mesh", "channel_sharding_for", "shard_state", "shard_model_and_optimizer",
           "shard_batch", "batch_group_for", "check_mesh", "axis_size", "axis_rank",
           "unsharded"]


def make_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``DeviceMesh`` of shape ``(data, model)``, dims ``("data",
    "model")``, over the initialized process group (``initialize``):
    ``model`` is the inner axis, so a rank's model peers are neighbours.
    It raises where the world is smaller than ``data * model``, as JAX's
    does, and also where it is larger (deliberately: with a process per
    card a rank outside the mesh would have nothing to run). ``device``
    None means CUDA."""
    from torch.distributed.device_mesh import DeviceMesh

    from .._device import resolve_device

    kind = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize(...) first")
    need, world = data * model, dist.get_world_size()
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    if world > need:
        raise ValueError(f"a ({data}, {model}) mesh takes {need} ranks; the world has {world}")
    return DeviceMesh(kind, torch.arange(need).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a mesh of :func:`make_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != ("data",
                                                                                "model"):
        raise TypeError(f"mesh must be a ('data', 'model') DeviceMesh from "
                        f"parallel.make_mesh, got {type(mesh).__name__}")


def axis_size(mesh, axis: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh, axis: str) -> int:
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def batch_group_for(n: int, mesh, axis: str = "data") -> Optional[dist.ProcessGroup]:
    """The group a batch of ``n`` rows reduces over: the ``axis`` group when
    :func:`shard_batch` splits it, None when it is replicated."""
    return None if n % axis_size(mesh, axis) else mesh.get_group(axis)


def shard_batch(batch: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``batch`` on the ``axis`` axis. A ragged batch
    (rows not divisible by the axis, e.g. the last eval batch) is
    replicated, as in the JAX package: every rank takes it whole."""
    size = axis_size(mesh, axis)
    n = batch.shape[0]
    if n % size:
        return batch
    k = n // size
    return batch[axis_rank(mesh, axis) * k:(axis_rank(mesh, axis) + 1) * k]


# ------------------------------------------------------------ the channel rule

@dataclasses.dataclass
class _Plan:
    """How one layer shards: ``dims`` maps its tensors (paths below it) to
    their out-channel dim; ``in_slice`` takes the input's channels of its
    own groups; ``out_dim`` is the dim its output gathers on; ``attrs``
    the attributes that describe the local layer; ``quantizers`` the
    quantizers that see a slice (they reduce over the model group)."""

    dims: Dict[str, int]
    in_slice: bool
    out_dim: int
    attrs: Dict[str, object]
    quantizers: Tuple[str, ...] = ()


def _qdims(m: nn.Module, prefix: str, dim: int):
    """A weight quantizer's per-channel buffers, or (as a slice-seeing
    quantizer) the quantizer itself when it is per tensor."""
    q = getattr(m, prefix, None)
    if q is None or not hasattr(q, "min_val"):
        return {}, ()
    if q.min_val.numel() == 1:
        return {}, (prefix,)
    return {f"{prefix}.{b}": dim for b in ("min_val", "max_val", "scale", "zero_point")}, ()


def _plan(m: nn.Module, size: int) -> Optional[_Plan]:
    from ..infer import engine as E
    from ..nn import modules as M
    from ..nn import qat_dorefa

    if size == 1 or isinstance(m, (qat_dorefa.QuantConv2d, qat_dorefa.QuantConvTranspose2d,
                                   qat_dorefa.QuantLinear)):
        return None

    def grouped(o, g):
        return o % size == 0 and (g == 1 or g % size == 0)

    if isinstance(m, M.Conv2d):
        o, g = m.out_channels, m.groups
        if not grouped(o, g):
            return None
        dims = {n: 0 for n in ("weight", "bias", "gamma", "beta", "running_mean",
                               "running_var") if getattr(m, n, None) is not None}
        qd, qs = _qdims(m, "weight_quantizer", 0)
        attrs = dict(out_channels=o // size)
        if g > 1:
            attrs.update(in_channels=m.in_channels // size, groups=g // size)
            if hasattr(m, "activation_quantizer"):
                qs = qs + ("activation_quantizer",)
        return _Plan({**dims, **qd}, g > 1, 1, attrs, qs)
    if isinstance(m, M.ConvTranspose2d):
        if m.groups != 1 or m.out_channels % size:
            return None
        dims = {"weight": 1, **({"bias": 0} if m.bias is not None else {})}
        _, qs = _qdims(m, "weight_quantizer", 1)
        return _Plan(dims, False, 1, dict(out_channels=m.out_channels // size), qs)
    if isinstance(m, M.Linear):
        if m.out_features % size:
            return None
        dims = {"weight": 1, **({"bias": 0} if m.bias is not None else {})}
        qd, qs = _qdims(m, "weight_quantizer", 1)
        return _Plan({**dims, **qd}, False, -1, dict(out_features=m.out_features // size), qs)
    if isinstance(m, M.BatchNorm2d):
        if m.num_features % size:
            return None
        return _Plan({n: 0 for n in ("weight", "bias", "running_mean", "running_var")}, True, 1,
                     dict(num_features=m.num_features // size))
    if isinstance(m, (E.IntConv2d, E.TernaryConv2d)):
        o, cg, kh, kw = m.w_shape
        if not grouped(o, m.groups):
            return None
        packed = getattr(m, "w_packed", False)
        codes = "w_q" if isinstance(m, E.IntConv2d) else "w_t"
        dims = {codes: 1 if packed else 0}
        dims.update({n: 0 for n in ("w_scale", "w_zp", "alpha", "bias")
                     if getattr(m, n, None) is not None})
        attrs = dict(w_shape=(o // size, cg, kh, kw), _gemm_cache=None)
        if m.groups > 1:
            attrs["groups"] = m.groups // size
        return _Plan(dims, m.groups > 1, 1, attrs)
    if isinstance(m, E.IntLinear):
        k, o = m.w_shape
        if o % size:
            return None
        dims = {n: 0 for n in ("w_scale", "w_zp", "bias") if getattr(m, n, None) is not None}
        return _Plan({"w_q": 1, **dims}, False, -1, dict(w_shape=(k, o // size)))
    return None


def channel_sharding_for(module: nn.Module, name: str, mesh, axis: str = "model") -> Optional[int]:
    """The dim of ``module``'s tensor ``name`` (a path below it, e.g.
    ``"weight_quantizer.min_val"``) that shards over ``mesh``'s ``axis``,
    or None where it is replicated. The out-channel axis comes from the
    module: OIHW kernels on 0 (a nibble-packed W4 engine kernel, (kh kw
    cg / 2, O), on 1), the (in, out) Linear kernel on 1, a transposed
    conv's (in, out, kh, kw) kernel on 1, vectors and per-channel conv
    statistics on 0, per-column linear statistics on 1. Nothing shards
    when the axis has one rank (pure data parallelism)."""
    plan = _plan(module, axis_size(mesh, axis))
    return None if plan is None else plan.dims.get(name)


def _resolve(m: nn.Module, path: str):
    owner, _, leaf = path.rpartition(".")
    return (m.get_submodule(owner) if owner else m), leaf


def _set(owner: nn.Module, leaf: str, value: torch.Tensor) -> None:
    cur = getattr(owner, leaf)
    if isinstance(cur, nn.Parameter):
        cur.data = value  # the same Parameter: the optimizer keeps it
    else:
        setattr(owner, leaf, value)


def _slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    k = t.shape[dim] // size
    return t.detach().narrow(dim, rank * k, k).clone()


class _ChannelParallel:
    """A sharded layer's hooks: before its forward the input's channel
    slice (grouped layers) or the whole input, whose gradient sums over the
    model ranks; after it the gather of its output."""

    def __init__(self, plan: _Plan, group, rank: int, size: int):
        self.plan, self.group, self.rank, self.size = plan, group, rank, size

    def before(self, module, args):
        x = args[0]
        x = split(x, 1, self.group) if self.plan.in_slice else sum_grad(x, self.group)
        return (x,) + tuple(args[1:])

    def after(self, module, args, out):
        return gather(out, self.plan.out_dim, self.group)


@torch.no_grad()
def shard_state(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Shard ``model`` in place over ``mesh``'s ``axis``: each layer of
    :func:`channel_sharding_for` keeps this rank's slice of its out
    channels and becomes channel-parallel; the rest is replicated.
    Returns the model."""
    size = axis_size(mesh, axis)
    if size == 1:
        return model
    group, rank = mesh.get_group(axis), axis_rank(mesh, axis)
    for m in list(model.modules()):
        plan = _plan(m, size)
        if plan is None or hasattr(m, "_channel_parallel"):
            continue
        for path, dim in plan.dims.items():
            owner, leaf = _resolve(m, path)
            _set(owner, leaf, _slice(getattr(owner, leaf), dim, rank, size))
        for k, v in plan.attrs.items():
            setattr(m, k, v)
        for q in plan.quantizers:
            m.get_submodule(q).shard_group = group
        cp = _ChannelParallel(plan, group, rank, size)
        m.register_forward_pre_hook(cp.before)
        m.register_forward_hook(cp.after)
        m._channel_parallel = cp
    return model


def _sharded(model: nn.Module):
    """(module, path, dim, hooks) of every sharded tensor of ``model``."""
    for m in model.modules():
        cp = getattr(m, "_channel_parallel", None)
        if cp is not None:
            for path, dim in cp.plan.dims.items():
                yield m, path, dim, cp


@torch.no_grad()
def shard_model_and_optimizer(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
                              mesh, axis: str = "model") -> None:
    """In place: :func:`shard_state` on ``model``, then the optimizer's
    per-parameter state (Adam's ``mu`` and ``nu``) sliced as its
    parameter (the parameters keep their identity, so the optimizer's
    groups still hold them). With one rank on ``axis`` nothing changes
    (pure data parallelism)."""
    shard_state(model, mesh, axis)
    if optimizer is None:
        return
    for m, path, dim, cp in _sharded(model):
        owner, leaf = _resolve(m, path)
        st = optimizer.state.get(getattr(owner, leaf))
        for field in ("mu", "nu"):
            if st and field in st and st[field].shape != getattr(owner, leaf).shape:
                st[field] = _slice(st[field], dim, cp.rank, cp.size)


@contextlib.contextmanager
def unsharded(model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None):
    """The whole state in place of each rank's slices (every rank takes
    part: the slices are gathered), for ``state_dict``, checkpoints and
    ``load_state``; on exit each rank keeps its slice of what the tensors
    then hold. The layers' forwards are not for use inside."""
    entries = list(_sharded(model))

    def full(t, dim, cp):
        return torch.cat(_gather_parts(t, cp.group), dim)

    with torch.no_grad():
        for m, path, dim, cp in entries:
            owner, leaf = _resolve(m, path)
            t = getattr(owner, leaf)
            st = optimizer.state.get(t) if optimizer is not None else None
            for field in ("mu", "nu"):
                if st and field in st:
                    st[field] = full(st[field], dim, cp)
            _set(owner, leaf, full(t, dim, cp))
    try:
        yield model
    finally:
        with torch.no_grad():
            for m, path, dim, cp in entries:
                owner, leaf = _resolve(m, path)
                t = getattr(owner, leaf)
                st = optimizer.state.get(t) if optimizer is not None else None
                for field in ("mu", "nu"):
                    if st and field in st:
                        st[field] = _slice(st[field], dim, cp.rank, cp.size)
                _set(owner, leaf, _slice(t, dim, cp.rank, cp.size))

