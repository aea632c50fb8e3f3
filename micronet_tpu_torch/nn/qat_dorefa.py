"""DoReFa QAT layers: the counterpart of ``micronet_tpu/nn/qat_dorefa.py``.

Stateless: the closed-form quantizers of :mod:`..quant.dorefa` carry no
observer or scale, so these layers are a conv or a linear with the input
and the weight fake-quantized. ``quant_inference=True`` skips the weight
quantizer (``pre_quantize_weights`` stored the quantized weights).

Code-storage lowering (``QuantConfig.act_codes``, resolved per call from
the input's device as in :mod:`.qat_iao`): the activation grid is
``k / (2^a - 1)``, integer codes exact in bf16 up to 8 bits, so the
contraction reads bf16 codes on the card and the fixed scale folds into
the epilogue, ``contract(c, w) * s``; the zero point is 0, so there is
no correction term.
"""

from __future__ import annotations

import torch

from ..quant import dorefa
from ..quant.config import QuantConfig
from . import functional as F
from .modules import Conv2d, ConvTranspose2d, Linear
from .qat_iao import _act_codes_enabled, _codes_dtype

__all__ = ["QuantConv2d", "QuantConvTranspose2d", "QuantLinear"]


def _codes_out(x, a_bits, w, bias, contract):
    """``contract(codes, w) * s (+ bias)``: the contraction in the codes'
    dtype (its output kept in it), then f32 and the scale; ``bias``
    already shaped to broadcast over the output."""
    dtype = _codes_dtype(x.device)
    c, s = dorefa.activation_codes(x, a_bits)
    out = contract(c.to(dtype), w.to(dtype)).to(torch.float32) * s
    return out if bias is None else out + bias


class _DorefaLayer:
    """The config fields the DoReFa layers keep."""

    def _set_cfg(self, cfg: QuantConfig) -> None:
        self.cfg = cfg
        self.a_bits = cfg.a_bits
        self.w_bits = cfg.w_bits
        self.quant_inference = cfg.quant_inference

    def _weight(self):
        return self.weight if self.quant_inference else dorefa.quantize_weight(self.weight,
                                                                               self.w_bits)


class QuantConv2d(_DorefaLayer, Conv2d):
    """Conv2d with DoReFa fake-quant on the input and the weight."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_cfg(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._weight()
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_out(x, self.a_bits, w,
                              None if self.bias is None else self.bias[:, None, None],
                              lambda a, k: F.conv2d(a, k, None, self.stride, self.padding,
                                                    self.dilation, self.groups))
        return F.conv2d(dorefa.quantize_activation(x, self.a_bits), w, self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class QuantConvTranspose2d(_DorefaLayer, ConvTranspose2d):
    """ConvTranspose2d with DoReFa fake-quant on the input and the weight
    (the weight's max-normalization spans the whole tensor, so its layout
    does not matter)."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_cfg(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._weight()
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_out(x, self.a_bits, w,
                              None if self.bias is None else self.bias[:, None, None],
                              lambda a, k: F.conv_transpose2d(
                                  a, k, None, self.stride, self.padding, self.output_padding,
                                  self.dilation, self.groups))
        return F.conv_transpose2d(dorefa.quantize_activation(x, self.a_bits), w, self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.dilation, self.groups)


class QuantLinear(_DorefaLayer, Linear):
    """Linear with DoReFa fake-quant on the input and the weight."""

    def __init__(self, *args, cfg: QuantConfig, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_cfg(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._weight()
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_out(x, self.a_bits, w, self.bias, torch.matmul)
        return F.linear(dorefa.quantize_activation(x, self.a_bits), w, self.bias)
