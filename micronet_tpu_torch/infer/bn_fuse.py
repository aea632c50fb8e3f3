"""Post-training BN fusion, both schemes: the counterpart of
``micronet_tpu/infer/bn_fuse.py``.

IAO: each trained ``QuantBNFuseConv2d`` becomes a
``QuantConv2d(quant_inference=True)`` whose weights and bias fold the
running statistics, with the quantizers' scale, zero_point and observer
range carried over; ``pre_quantize_weights`` then applies each weight
quantizer once, so only the activation fake-quant runs at inference.

wbwtab: a conv whose output feeds a sign folds its BN into the bias only,
since the positive per-channel scale ``std / gamma`` keeps every sign:

- gamma > 0: ``w' = w``, ``b' = b - mean + beta * (std / gamma)``;
- gamma < 0: ``w' = -w`` (OIHW: the first axis), ``b' = mean - b - beta *
  (std / gamma)``;
- gamma == 0: left as it is.

The binary range is convs 1..N, N the number of ``ActivationQuantizer``
modules; convs 2..N become ``QuantConv2d(quant_inference=True)``, conv 1
and the convs past N plain ``Conv2d``, and the convs past N take the
standard fold ``w * gamma / std``, ``beta + (b - mean) * gamma / std``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from ..nn import modules as M
from ..nn import qat_iao, qat_wbwtab
from ..nn.transform import _children, _conv_args, _copy_model
from ..quant import wbwtab
from ..quant.config import QuantConfig
from ..quant.quantizers import fake_quant

__all__ = ["fuse_bn_iao", "fuse_bn_wbwtab", "pre_quantize_weights"]


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
        elif isinstance(m, qat_wbwtab.QuantConv2d):
            m.weight.copy_(wbwtab.quantize_weight(m.weight, m.W)[0])
    return model


@torch.no_grad()
def _fuse_wbwtab_pair(conv: M.Conv2d, bn: M.BatchNorm2d,
                      binary: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (weight, bias) of one Conv/BN pair, in the JAX package's order
    of f32 operations."""
    mean, gamma, beta = bn.running_mean, bn.weight, bn.bias
    std = F.sqrt(bn.running_var + bn.eps)
    w = conv.weight
    b = conv.bias if conv.bias is not None else torch.zeros_like(mean)
    if not binary:
        return w * (gamma / std)[:, None, None, None], beta + (b - mean) * (gamma / std)
    pos, neg = gamma > 0, gamma < 0
    w_fused = torch.where(neg[:, None, None, None], -w, w)
    b_fused = torch.where(pos, b - mean + beta * (std / gamma), b)
    return w_fused, torch.where(neg, mean - b - beta * (std / gamma), b_fused)


def fuse_bn_wbwtab(model: nn.Module, cfg: QuantConfig, *, inplace: bool = False,
                   device=None) -> nn.Module:
    """wbwtab export: BN -> bias fusion over the binary-activation range.
    ``model`` has trained wbwtab weights with its Conv/BN pairs intact;
    only the placement of convs, BNs and ``ActivationQuantizer`` matters.
    Returns the inference model on ``device`` (None = CUDA): convs 2..N as
    ``QuantConv2d(quant_inference=True)`` with pre-quantized weights,
    conv 1 and the convs past N plain, every BN an ``Identity``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, quant_inference=True)
    if not inplace:
        model = _copy_model(model)
    model.to(dev)
    bin_num = sum(isinstance(m, qat_wbwtab.ActivationQuantizer) for m in model.modules())
    counter = [0]

    @torch.no_grad()
    def fuse_pair(conv, bn):
        counter[0] += 1
        k = counter[0]
        w_fused, b_fused = _fuse_wbwtab_pair(conv, bn, 1 <= k <= bin_num)
        args = {**_conv_args(conv), "bias": True}
        if 2 <= k <= bin_num:
            out = qat_wbwtab.QuantConv2d(cfg=cfg, device=dev, **args)
        else:
            out = M.Conv2d(device=dev, **args)
        out.weight.copy_(w_fused)
        out.bias.copy_(b_fused)
        return out

    def rec(module: nn.Module) -> None:
        pending = None
        for _, child, set_child in _children(module):
            if type(child) in (M.Conv2d, qat_wbwtab.QuantConv2d):
                pending = (child, set_child)
            elif type(child) is M.BatchNorm2d and pending is not None:
                conv, set_conv = pending
                pending = None
                set_conv(fuse_pair(conv, child))
                set_child(M.Identity())
            else:
                rec(child)

    rec(model)
    pre_quantize_weights(model)
    return model
