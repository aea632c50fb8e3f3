"""Utilities of the port: profiling and roofline reporting, the JSONL
metrics sink.

Left out: ``per_step_seconds`` and ``throughput``, the JAX package's
timing harness for a TPU (``utils/timing.py``); the port times with CUDA
events (``chip_smoke.py``)."""

from .metrics import MetricsLogger
from .profiling import CHIPS, ChipSpec, current_chip, roofline, trace

__all__ = ["roofline", "trace", "current_chip", "CHIPS", "ChipSpec", "MetricsLogger"]
