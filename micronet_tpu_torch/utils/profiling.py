"""Profiling and roofline reporting: the counterpart of
``micronet_tpu/utils/profiling.py``.

- :func:`trace`: a context manager around ``torch.profiler`` (CPU and, with
  a card, CUDA activities) that writes a trace Chrome
  (``chrome://tracing``) or TensorBoard's profiler plugin opens.
- :func:`roofline`: given measured seconds and a workload's operations
  and bytes, utilization against a card's peaks and which ceiling binds
  (the JAX package's keys and arithmetic).
- :data:`CHIPS`: the published dense peaks of NVIDIA's H100 (data sheet,
  no sparsity) in place of the JAX package's TPU table.
- :func:`span`: the port's own spans (``engine.*`` in
  ``infer/deploy.py``'s ``CompiledEngine``, ``int.*`` by role in the
  integer engine's modules, ``train.*`` in ``Trainer.train_step`` and the
  augmentation), recorded in memory while :func:`spans_on` (or
  :func:`trace`) holds and read back with :func:`take_spans`. A span's
  stamps are ``time.time_ns()``, the clock of the profiler's chrome trace
  (``baseTimeNanoseconds`` + ``ts`` x 1000); under a running profiler a
  span also enters ``record_function``, so it lands in the trace as a
  ``user_annotation``. A span launches no device work and never
  synchronizes. Off (the default) it costs one flag read and returns a
  shared no-op context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["ChipSpec", "CHIPS", "current_chip", "roofline", "trace", "span", "spans_on",
           "take_spans", "SpanRecord", "MAX_SPANS"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A card's peaks: tensor-core bf16 and int8 rates, device memory rate,
    the FP32 rate outside the tensor cores (``f32_tflops``), and
    ``vmem_mb``, the shared memory of one SM (the programmer-managed
    on-chip memory, as VMEM is a TPU core's)."""

    name: str
    bf16_tflops: float
    int8_tops: float
    hbm_gbps: float
    f32_tflops: float
    vmem_mb: float = 0.228

    @property
    def int4_tops(self) -> float:
        # Hopper has no int4 tensor-core path: int4 weights run the int8
        # (or bf16) units, and their gain is bytes, not operations
        return self.int8_tops


CHIPS: Dict[str, ChipSpec] = {
    "h100_sxm": ChipSpec("h100_sxm", bf16_tflops=989, int8_tops=1979, hbm_gbps=3350,
                         f32_tflops=67),
    "h100_pcie": ChipSpec("h100_pcie", bf16_tflops=756, int8_tops=1513, hbm_gbps=2000,
                          f32_tflops=51),
}


def current_chip(default: str = "h100_sxm") -> ChipSpec:
    """Best-effort detection from ``torch.cuda.get_device_name()``; the
    ``default`` entry without a card or for a card not in the table."""
    if not torch.cuda.is_available():
        return CHIPS[default]
    name = torch.cuda.get_device_name().lower()
    if "h100" in name:
        return CHIPS["h100_pcie" if "pcie" in name else "h100_sxm"]
    return CHIPS[default]


def roofline(
    seconds: float,
    *,
    flops: float = 0.0,
    bytes_accessed: float = 0.0,
    dtype: str = "bf16",
    chip: Optional[ChipSpec] = None,
) -> Dict[str, float]:
    """Utilization report for one kernel/step execution.

    Returns compute/bandwidth utilization fractions, the achievable-time
    bound, and ``fraction_of_roofline`` = bound / measured (1.0 = at the
    roofline). ``dtype`` is ``bf16``, ``f32`` (the FP32 units outside the
    tensor cores), ``int8`` or ``int4``.
    """
    chip = chip or current_chip()
    peak_flops = {
        "bf16": chip.bf16_tflops * 1e12,
        "f32": chip.f32_tflops * 1e12,
        "int8": chip.int8_tops * 1e12,
        "int4": chip.int4_tops * 1e12,
    }[dtype]
    t_compute = flops / peak_flops if flops else 0.0
    t_memory = bytes_accessed / (chip.hbm_gbps * 1e9) if bytes_accessed else 0.0
    bound = max(t_compute, t_memory)
    return {
        "seconds": seconds,
        "compute_util": t_compute / seconds if seconds else 0.0,
        "bandwidth_util": t_memory / seconds if seconds else 0.0,
        "bound_seconds": bound,
        "fraction_of_roofline": (bound / seconds) if seconds else 0.0,
        "binding": float(t_compute >= t_memory),  # 1.0 compute-bound
    }


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``with trace("build/trace"):`` records the CPU and (with a card) the
    CUDA activity of the block, the port's spans among it, and writes it
    into ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json``. The spans
    are the trace's: unless spans were on before, the recorder keeps none
    of the block's."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    keep = _on
    with _lock:
        buffer, start = _buffer, len(_buffer)
    try:
        with spans_on(), profile(activities=acts,
                                 on_trace_ready=tensorboard_trace_handler(logdir)):
            yield
    finally:
        if not keep:
            with _lock:
                if _buffer is buffer:
                    del _buffer[start:]
                else:  # taken inside the block: what is there now is the block's
                    _buffer.clear()


# -- spans ---------------------------------------------------------------------

MAX_SPANS = 1 << 20  # records the buffer holds; spans past it are counted, not kept


class SpanRecord(NamedTuple):
    """One span: its stamps (``time.time_ns()``; ``end_ns`` None while it
    is open), ``parent``, the index in the same buffer of the span that
    enclosed it on its thread (None at the outermost), and ``root``, the
    number of its outermost span (one per engine call or training
    step)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    root: int


# The recorder is the process's, as the profiler is: spans open deep inside
# the engine's modules and the trainer, where no recorder could be passed.
_on = False  # the one flag the off path reads
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_buffer: List[list] = []
_dropped = 0
_roots = itertools.count()
_local = threading.local()


class _Span:
    __slots__ = ("name", "record", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, root = stack[-1] if stack else (None, next(_roots))
        self.record = [self.name, time.time_ns(), None, parent, root]
        with _lock:
            if len(_buffer) < MAX_SPANS:
                index = len(_buffer)
                _buffer.append(self.record)
            else:
                index = None
                _dropped += 1
        stack.append((index, root))
        self.annotation = None
        if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
            self.annotation = torch.autograd.profiler.record_function(self.name)
            self.annotation.__enter__()

    def __exit__(self, *exc) -> None:
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.record[2] = time.time_ns()
        _local.stack.pop()


def span(name: str):
    """``with span("engine.call"):`` records the block as a span while
    spans are on; off, it reads one flag and returns the one shared no-op
    context (no allocation, no call into ``torch``). A no-op as well
    while ``torch.compile`` or ``torch.export`` traces."""
    if not _on or torch.compiler.is_compiling():
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def spans_on() -> Iterator[None]:
    """Record spans for the block (the previous setting comes back after)."""
    global _on
    prev, _on = _on, True
    try:
        yield
    finally:
        _on = prev


def take_spans() -> Tuple[List[SpanRecord], int]:
    """The spans recorded since the last call, in the order they opened,
    and how many the full buffer dropped; empties both. Take them when no
    span is open: an open span's record stays open in what is returned."""
    global _buffer, _dropped
    with _lock:
        taken, dropped = _buffer, _dropped
        _buffer, _dropped = [], 0
    return [SpanRecord(*r) for r in taken], dropped
