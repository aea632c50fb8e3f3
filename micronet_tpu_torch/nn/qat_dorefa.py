"""DoReFa QAT layers: the counterpart of ``micronet_tpu/nn/qat_dorefa.py``.

Stateless: the closed-form quantizers of :mod:`..quant.dorefa` carry no
observer or scale, so these layers are a conv or a linear with the input
and the weight fake-quantized. ``quant_inference=True`` skips the weight
quantizer (``pre_quantize_weights`` stored the quantized weights).

Every config runs the exact f32 composition; the JAX package's
code-storage lowering (``act_codes``) is an accelerator lowering of the
same values and is not ported.
"""

from __future__ import annotations

import torch

from ..quant import dorefa
from ..quant.config import QuantConfig
from . import functional as F
from .modules import Conv2d, ConvTranspose2d, Linear

__all__ = ["QuantConv2d", "QuantConvTranspose2d", "QuantLinear"]


class QuantConv2d(Conv2d):
    """Conv2d with DoReFa fake-quant on the input and the weight."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self.a_bits = cfg.a_bits
        self.w_bits = cfg.w_bits
        self.quant_inference = cfg.quant_inference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else dorefa.quantize_weight(self.weight,
                                                                             self.w_bits)
        return F.conv2d(dorefa.quantize_activation(x, self.a_bits), w, self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class QuantConvTranspose2d(ConvTranspose2d):
    """ConvTranspose2d with DoReFa fake-quant on the input and the weight
    (the weight's max-normalization spans the whole tensor, so its layout
    does not matter)."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self.a_bits = cfg.a_bits
        self.w_bits = cfg.w_bits
        self.quant_inference = cfg.quant_inference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else dorefa.quantize_weight(self.weight,
                                                                             self.w_bits)
        return F.conv_transpose2d(dorefa.quantize_activation(x, self.a_bits), w, self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.dilation, self.groups)


class QuantLinear(Linear):
    """Linear with DoReFa fake-quant on the input and the weight."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self.a_bits = cfg.a_bits
        self.w_bits = cfg.w_bits
        self.quant_inference = cfg.quant_inference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else dorefa.quantize_weight(self.weight,
                                                                             self.w_bits)
        return F.linear(dorefa.quantize_activation(x, self.a_bits), w, self.bias)
