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
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, Optional

import torch

__all__ = ["ChipSpec", "CHIPS", "current_chip", "roofline", "trace"]


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
    CUDA activity of the block and writes it into ``logdir`` as
    ``<host>_<pid>.<time>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
