"""Utilities of the port: profiling and roofline reporting, the port's
own spans, the JSONL metrics sink.

Left out: ``per_step_seconds`` and ``throughput``, the JAX package's
timing harness for a TPU (``utils/timing.py``). The port times a step
with CUDA events (``train/loop.py``'s per-step ``step_ms``, and
``chip_smoke.py``), and records spans of its layers on the host
(``profiling.span``), which a ``torch.profiler`` trace carries beside
the kernels they launched."""

from .metrics import MetricsLogger
from .profiling import (CHIPS, ChipSpec, current_chip, roofline, span, spans_on, take_spans,
                        trace)

__all__ = ["roofline", "trace", "current_chip", "CHIPS", "ChipSpec", "MetricsLogger", "span",
           "spans_on", "take_spans"]
