"""Post-training BN fusion, IAO scheme: the counterpart of
``micronet_tpu/infer/bn_fuse.py`` (``fuse_bn_wbwtab`` is not ported yet).

Each trained ``QuantBNFuseConv2d`` becomes a
``QuantConv2d(quant_inference=True)`` whose weights and bias fold the
running statistics, with the quantizers' scale, zero_point and observer
range carried over; ``pre_quantize_weights`` then applies each weight
quantizer once, so only the activation fake-quant runs at inference.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from ..nn import qat_iao
from ..nn.transform import _children, _conv_args, _copy_model
from ..quant.config import QuantConfig
from ..quant.quantizers import fake_quant

__all__ = ["fuse_bn_iao", "pre_quantize_weights"]


@torch.no_grad()
def _copy_quantizer_state(dst: qat_iao.FakeQuantizer, src: qat_iao.FakeQuantizer) -> None:
    for name in ("scale", "zero_point", "min_val", "max_val", "initialized"):
        getattr(dst, name).copy_(getattr(src, name))


@torch.no_grad()
def _fuse_iao_conv(bn_conv: qat_iao.QuantBNFuseConv2d, cfg: QuantConfig) -> qat_iao.QuantConv2d:
    mean = bn_conv.running_mean
    std = F.sqrt(bn_conv.running_var + bn_conv.eps)
    gamma, beta, w = bn_conv.gamma, bn_conv.beta, bn_conv.weight
    b = bn_conv.bias if bn_conv.bias is not None else torch.zeros_like(mean)
    # this layer's own trained bit widths, which differ from the body's
    # under the first/last-layer overrides
    layer_cfg = dataclasses.replace(cfg, a_bits=bn_conv.activation_quantizer.bits,
                                    w_bits=bn_conv.weight_quantizer.bits)
    q = qat_iao.QuantConv2d(cfg=layer_cfg, device=w.device,
                            **{**_conv_args(bn_conv), "bias": True})
    q.weight.copy_(w * (gamma / std)[:, None, None, None])
    q.bias.copy_(beta + (b - mean) * (gamma / std))
    _copy_quantizer_state(q.activation_quantizer, bn_conv.activation_quantizer)
    _copy_quantizer_state(q.weight_quantizer, bn_conv.weight_quantizer)
    return q


def fuse_bn_iao(model: nn.Module, cfg: QuantConfig, *, inplace: bool = False,
                device=None) -> nn.Module:
    """``QuantBNFuseConv2d`` -> ``QuantConv2d(quant_inference=True)``.
    ``cfg`` must match training (bits, q_type, q_level);
    ``quant_inference`` and ``qaft`` are forced so the fused model runs
    frozen. The result lies on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, quant_inference=True, qaft=True, bn_fuse=False)
    if not inplace:
        model = _copy_model(model)
    model.to(dev)

    def rec(module: nn.Module) -> None:
        for _, child, set_child in _children(module):
            if isinstance(child, qat_iao.QuantBNFuseConv2d):
                set_child(_fuse_iao_conv(child, cfg))
            else:
                rec(child)

    rec(model)
    pre_quantize_weights(model)
    return model


@torch.no_grad()
def pre_quantize_weights(model: nn.Module) -> nn.Module:
    """Apply each layer's weight quantizer once and store the result, so
    that with ``quant_inference=True`` only the activation fake-quant
    remains at run time."""
    for m in model.modules():
        if isinstance(m, (qat_iao.QuantConv2d, qat_iao.QuantLinear)):
            wq = m.weight_quantizer
            if wq.bits in (1, 32):
                continue
            m.weight.copy_(fake_quant(m.weight, wq.scale, wq.zero_point, wq.qmin, wq.qmax,
                                      wq.min_val, wq.max_val, wq.symmetric))
    return model
