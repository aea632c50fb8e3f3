"""bf16 inference mode: the TensorRT fp16-engine flag
(``deploy/tensorrt/util_trt.py:56-70``), the counterpart of
``micronet_tpu/infer/bf16.py``.

Casting parameters, buffers and inputs to bfloat16 halves the bytes a
forward reads and runs the convolutions and matmuls on the card's bf16
tensor cores, which accumulate in f32 and round each result to bf16, so
the whole network stays bf16 end to end.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["to_bf16", "bf16_runner"]


def to_bf16(model: nn.Module) -> nn.Module:
    """Cast every floating parameter and buffer of the model to bfloat16, in
    place (integer buffers, such as an engine's codes, stay).

    Intended for eval-mode models (fused exports, engines, float models);
    training state (Adam moments, BN stat accumulation) wants f32: convert
    after export, as TRT builds the fp16 engine from the f32 network.
    """
    return model.to(dtype=torch.bfloat16)


def bf16_runner(model: nn.Module):
    """A callable that feeds the bf16 model bf16 inputs and returns f32
    outputs: the drop-in serving entry point."""

    def run(x: torch.Tensor) -> torch.Tensor:
        return model(x.to(torch.bfloat16)).to(torch.float32)

    return run
