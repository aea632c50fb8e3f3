"""``prepare()``, the model-tree quantization transform: the counterpart of
``micronet_tpu/nn/transform.py`` (IAO and wbwtab; DoReFa is not ported
yet).

IAO: Conv2d -> QuantConv2d, or with ``bn_fuse`` the pair (Conv2d,
following sibling BatchNorm2d) -> (QuantBNFuseConv2d, Identity); Linear,
the pools and Add -> their quant variants. A plain ReLU is left alone.

wbwtab: every Conv2d but the first and the last -> the wbwtab
QuantConv2d; every ReLU after the first conv and before the last ->
``ActivationQuantizer``. BatchNorms stay (``fuse_bn_wbwtab`` folds them).
The walk visits children in insertion order, flattening a
``Sequential``'s ``layers`` list into the ``Sequential``'s scope, so
Conv -> BN adjacency follows the order the model defined them in.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..quant.config import QuantConfig
from . import modules as M
from . import qat_iao, qat_wbwtab

__all__ = ["prepare", "prepare_iao", "prepare_wbwtab"]

Setter = Callable[[nn.Module], None]


def _children(module: nn.Module) -> Iterator[Tuple[str, nn.Module, Setter]]:
    """Yield (name, child, setter) in definition order; the items of a
    ``ModuleList`` (a ``Sequential``'s ``layers``) appear in its owner's
    scope as ``name[i]``."""
    for name, child in list(module.named_children()):
        if isinstance(child, nn.ModuleList):
            for i, item in enumerate(child):

                def _set(new, _lst=child, _i=i):
                    _lst[_i] = new

                yield f"{name}[{i}]", item, _set
        else:

            def _set(new, _mod=module, _name=name):
                setattr(_mod, _name, new)

            yield name, child, _set


def _copy_model(model: nn.Module) -> nn.Module:
    return copy.deepcopy(model)


def _conv_args(c: M.Conv2d) -> dict:
    return dict(in_channels=c.in_channels, out_channels=c.out_channels,
                kernel_size=c.kernel_size, stride=c.stride, padding=c.padding,
                dilation=c.dilation, groups=c.groups, bias=c.bias is not None)


@torch.no_grad()
def _copy_wb(dst: nn.Module, src: nn.Module) -> None:
    dst.weight.copy_(src.weight)
    if src.bias is not None:
        dst.bias.copy_(src.bias)


def _count_quantizable_iao(module: nn.Module, bn_fuse: bool) -> int:
    """Number of conv/linear layers :func:`_add_quant_op_iao` quantizes,
    by the same walk (with ``bn_fuse`` a Conv2d counts only when a
    following sibling BatchNorm2d pairs with it)."""
    total = 0
    pending = False
    for _, child, _ in _children(module):
        if type(child) is M.Conv2d:
            if bn_fuse:
                pending = True
            else:
                total += 1
        elif type(child) is M.BatchNorm2d and bn_fuse and pending:
            pending = False
            total += 1
        elif type(child) is M.Linear:
            total += 1
        else:
            total += _count_quantizable_iao(child, bn_fuse)
    return total


def _layer_cfg(cfg: QuantConfig, idx: int, total: int) -> QuantConfig:
    """Apply the first/last-layer bit overrides."""
    a, w = cfg.a_bits, cfg.w_bits
    if idx == 0:
        a = cfg.first_layer_a_bits or a
        w = cfg.first_layer_w_bits or w
    if idx == total - 1:
        a = cfg.last_layer_a_bits or a
        w = cfg.last_layer_w_bits or w
    if (a, w) == (cfg.a_bits, cfg.w_bits):
        return cfg
    return dataclasses.replace(cfg, a_bits=a, w_bits=w)


def _add_quant_op_iao(module: nn.Module, cfg: QuantConfig, dev: torch.device,
                      _ctr: Optional[list] = None, _total: int = 0) -> None:
    if _ctr is None:
        _ctr = [0]
        _total = _count_quantizable_iao(module, cfg.bn_fuse)

    def next_cfg() -> QuantConfig:
        c = _layer_cfg(cfg, _ctr[0], _total)
        _ctr[0] += 1
        return c

    pending_conv: Optional[Tuple[M.Conv2d, Setter]] = None
    for _, child, set_child in _children(module):
        # exact-type checks: quant layers subclass the float layers, and
        # already-prepared modules must not be wrapped again
        if type(child) is M.Conv2d:
            if cfg.bn_fuse:
                pending_conv = (child, set_child)
            else:
                q = qat_iao.QuantConv2d(cfg=next_cfg(), device=dev, **_conv_args(child))
                _copy_wb(q, child)
                set_child(q)
        elif type(child) is M.BatchNorm2d and cfg.bn_fuse and pending_conv is not None:
            conv, set_conv = pending_conv
            pending_conv = None
            q = qat_iao.QuantBNFuseConv2d(eps=child.eps, momentum=child.momentum,
                                          cfg=next_cfg(), device=dev, **_conv_args(conv))
            _copy_wb(q, conv)
            with torch.no_grad():
                q.gamma.copy_(child.weight)
                q.beta.copy_(child.bias)
                q.running_mean.copy_(child.running_mean)
                q.running_var.copy_(child.running_var)
            set_conv(q)
            set_child(M.Identity())
        elif type(child) is M.Linear:
            q = qat_iao.QuantLinear(child.in_features, child.out_features,
                                    bias=child.bias is not None, cfg=next_cfg(), device=dev)
            _copy_wb(q, child)
            set_child(q)
        elif type(child) is M.MaxPool2d:
            set_child(qat_iao.QuantMaxPool2d(child.kernel_size, child.stride, child.padding,
                                             cfg=cfg, device=dev))
        elif type(child) is M.AvgPool2d:
            set_child(qat_iao.QuantAvgPool2d(child.kernel_size, child.stride, child.padding,
                                             cfg=cfg, device=dev))
        elif type(child) is M.AdaptiveAvgPool2d:
            set_child(qat_iao.QuantAdaptiveAvgPool2d(child.output_size, cfg=cfg, device=dev))
        elif type(child) is M.Add:
            set_child(qat_iao.QuantAdd(cfg=cfg, device=dev))
        else:
            _add_quant_op_iao(child, cfg, dev, _ctr, _total)


def prepare_iao(model: nn.Module, cfg: QuantConfig, *, inplace: bool = False,
                device=None) -> nn.Module:
    """IAO prepare. The prepared model lies on ``device`` (None = CUDA,
    which raises without a card; pass ``"cpu"`` for the plain path)."""
    dev = resolve_device(device)
    if not inplace:
        model = _copy_model(model)
    model.to(dev)
    _add_quant_op_iao(model, cfg, dev)
    return model


def _count_convs(module: nn.Module) -> int:
    n = 0
    for _, child, _ in _children(module):
        n += 1 if type(child) is M.Conv2d else _count_convs(child)
    return n


def _add_quant_op_wbwtab(module: nn.Module, cfg: QuantConfig, dev: torch.device,
                         counter: list, layer_num: int) -> None:
    for _, child, set_child in _children(module):
        if type(child) is M.Conv2d:
            counter[0] += 1
            if 1 < counter[0] < layer_num:  # skip the first AND the last
                q = qat_wbwtab.QuantConv2d(cfg=cfg, device=dev, **_conv_args(child))
                _copy_wb(q, child)
                set_child(q)
        elif type(child) is M.ReLU:
            if 0 < counter[0] < layer_num:
                set_child(qat_wbwtab.ActivationQuantizer(A=cfg.A))
        else:
            _add_quant_op_wbwtab(child, cfg, dev, counter, layer_num)


def prepare_wbwtab(model: nn.Module, cfg: QuantConfig, *, inplace: bool = False,
                   device=None) -> nn.Module:
    """wbwtab prepare, on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    if not inplace:
        model = _copy_model(model)
    model.to(dev)
    _add_quant_op_wbwtab(model, cfg, dev, [0], _count_convs(model))
    return model


_PREPARE = {"iao": prepare_iao, "wbwtab": prepare_wbwtab}


def prepare(model: nn.Module, cfg: Optional[QuantConfig] = None, *, method: str = "iao",
            inplace: bool = False, device=None, **overrides) -> nn.Module:
    """Rewrite ``model``'s tree with quant layers per ``method``.
    ``overrides`` update fields of ``cfg`` (or of a default QuantConfig)."""
    if method == "dorefa":
        raise NotImplementedError(
            "method 'dorefa' is not ported yet (ROADMAP.md, Queue 1: DoReFa)")
    if method not in _PREPARE:
        raise ValueError(f"unknown method {method!r}; pick from ['dorefa', 'iao', 'wbwtab']")
    cfg = cfg or QuantConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return _PREPARE[method](model, cfg, inplace=inplace, device=device)
