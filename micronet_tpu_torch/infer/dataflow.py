"""Dataflow tracing for module graphs, the engine planner's eyes: the
counterpart of ``micronet_tpu/infer/dataflow.py``.

The int8 chain planner must know which module consumes each module's
output; definition order is wrong for branching graphs (residual adds,
concats). One eager forward on an example input runs with a forward hook
on every module of the node types, recording ``(module, input
producers)`` for every tensor argument (both inputs of an add or a
concat) and the output's producer. Containers need no hook: they return their last
child's output tensor object. ``channel_shuffle`` is value-preserving on
int8 codes and registers an alias. Any other untracked op (a bare
``torch.relu`` in a model's forward) breaks provenance, which fails
safe: links through it are never chained and stay f32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["Trace", "trace_dataflow"]


class Trace:
    """Per-call records of a traced forward and the producer map."""

    def __init__(self):
        self.calls: List[Tuple[nn.Module, Tuple[Optional[nn.Module], ...]]] = []
        self._producer: Dict[int, nn.Module] = {}
        self._keep: list = []  # id() keys must not be recycled

    def record(self, mod: nn.Module, args, out) -> None:
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        self.calls.append((mod, tuple(self._producer.get(id(a)) for a in tensors)))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor):
                self._producer[id(o)] = mod
                self._keep.append(o)
        self._keep.extend(tensors)

    def alias(self, new: torch.Tensor, old: torch.Tensor) -> None:
        """``new`` carries the value ``old`` was produced with."""
        p = self._producer.get(id(old))
        if p is not None:
            self._producer[id(new)] = p
            self._keep.append(new)

    def consumers(self) -> Dict[int, List[nn.Module]]:
        """id(module) -> the modules that consumed one of its outputs."""
        out: Dict[int, List[nn.Module]] = {}
        for mod, ins in self.calls:
            for p in ins:
                if p is not None:
                    out.setdefault(id(p), []).append(mod)
        return out

    def call_counts(self) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for mod, _ in self.calls:
            counts[id(mod)] = counts.get(id(mod), 0) + 1
        return counts


@contextlib.contextmanager
def _hooks(model: nn.Module, types: Sequence[type], trace: Trace):
    handles = [m.register_forward_hook(lambda mod, args, out: trace.record(mod, args, out))
               for m in model.modules() if isinstance(m, tuple(types))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _patched_shuffle(trace: Trace):
    from ..nn import functional as F

    orig = F.channel_shuffle

    def wrapper(x, groups):
        out = orig(x, groups)
        trace.alias(out, x)
        return out

    F.channel_shuffle = wrapper
    try:
        yield
    finally:
        F.channel_shuffle = orig


@torch.no_grad()
def trace_dataflow(model: nn.Module, example_input: torch.Tensor,
                   node_types: Sequence[type]) -> Trace:
    """One eager forward of ``model`` on zeros shaped like
    ``example_input``, recording the calls of modules of ``node_types``.
    Give the real spatial and channel shape (the batch may be 1)."""
    trace = Trace()
    x = torch.zeros_like(example_input)
    with _hooks(model, node_types, trace), _patched_shuffle(trace):
        model(x)
    return trace
