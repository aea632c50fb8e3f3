"""wbwtab QAT layers: the counterpart of ``micronet_tpu/nn/qat_wbwtab.py``.

Weights quantize inside the conv; activations binarize in a separate
:class:`ActivationQuantizer` standing where a ``ReLU`` was. The W == 2
path of the reference centres and clamps the master weight in place; the
forward uses the centred weight (through ``quantize_weight``) and
:func:`project_params` writes the projection back between steps.

Not ported yet: ``QuantConvTranspose2d`` (the port has no
``ConvTranspose2d``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..quant import wbwtab
from ..quant.config import QuantConfig
from . import functional as F
from .modules import Conv2d

__all__ = ["ActivationQuantizer", "QuantConv2d", "project_params"]


class ActivationQuantizer(nn.Module):
    """Binary activation (A == 2) or plain ReLU."""

    def __init__(self, A: int = 2):
        super().__init__()
        self.A = A

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return wbwtab.quantize_activation(x, self.A)


class QuantConv2d(Conv2d):
    """Weight-quantized conv. With ``quant_inference`` the weights were
    pre-quantized by the export pass and the quantizer is skipped."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self.W = cfg.W
        self.quant_inference = cfg.quant_inference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if not self.quant_inference:
            w, _ = wbwtab.quantize_weight(w, self.W)
        return F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)


@torch.no_grad()
def project_params(model: nn.Module) -> None:
    """Write the mean-centre + clamp projection back into every binary
    (W == 2) conv's master weight, as the reference's in-place update
    does; call it between optimizer steps."""
    for m in model.modules():
        if isinstance(m, QuantConv2d) and m.W == 2:
            m.weight.copy_(wbwtab.mean_center_clamp(m.weight))
