"""IAO (integer-arithmetic-only) QAT layers: the counterpart of
``micronet_tpu/nn/qat_iao.py``.

Quantizer state (observer min/max, scale, zero_point, the BN running
statistics of fused convs) lives in buffers: it rides ``state_dict`` and
is never optimized. Buffer names are the JAX package's variable names.

Mode semantics: in training mode (and not ``qaft``) each forward updates
the observers and refreshes scale/zero_point, then fake-quantizes; in
eval mode (or under ``qaft``) the stored state is used as it is.

Granularity: "L" = per-tensor; per-out-channel conv weights reduce the
OIHW axes (1, 2, 3) to (O, 1, 1, 1); per-column linear weights reduce
the (in, out) axis 0 to (1, O).

Not ported yet: the histogram and entropy observers (PTQ/KL), the
``act_codes`` and ``bn_stats`` lowerings (every config runs the exact f32
composition), ``QuantConvTranspose2d``, ``QuantConcat``,
``QuantLeakyReLU`` and ``QuantSigmoid``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..quant.config import QuantConfig
from ..quant.observers import MinMaxState, ema_minmax_update, minmax_update
from ..quant.quantizers import asymmetric_qparams, fake_quant, quant_range, symmetric_qparams
from . import functional as F
from .functional import IntPair, _pair
from .modules import Conv2d, Device, Linear

__all__ = [
    "FakeQuantizer",
    "QuantConv2d",
    "QuantBNFuseConv2d",
    "QuantLinear",
    "QuantReLU",
    "QuantMaxPool2d",
    "QuantAvgPool2d",
    "QuantAdaptiveAvgPool2d",
    "QuantAdd",
]

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1: PTQ/QAFT/KL calibration)"


class FakeQuantizer(nn.Module):
    """One fake-quant chain: observer, qparams and clip-STE round.

    ``observer`` is ``"minmax"`` (cumulative) or ``"ema"``. ``union=True``
    is ``QuantAdd``'s shared quantizer: it never observes, but refreshes
    its qparams each training step from the min/max assigned to it.
    """

    def __init__(self, bits: int, *, symmetric: bool = True, is_weight: bool = False,
                 stat_shape: Tuple[int, ...] = (1,), axes: Optional[Tuple[int, ...]] = None,
                 observer: str = "ema", momentum: float = 0.1, qaft: bool = False,
                 union: bool = False, device: Device = None):
        super().__init__()
        if observer not in ("minmax", "ema"):
            raise NotImplementedError(f"observer {observer!r} is {_NOT_PORTED}")
        dev = resolve_device(device)
        self.bits = bits
        self.symmetric = symmetric
        self.is_weight = is_weight
        self.axes = None if axes is None else tuple(axes)
        self.observer = observer
        self.momentum = momentum
        self.qaft = qaft
        self.union = union
        if bits not in (1, 32):
            self.qmin, self.qmax = quant_range(bits, symmetric, is_weight)
        else:
            self.qmin, self.qmax = 0.0, 0.0
        shape = tuple(stat_shape)
        self.register_buffer("min_val", torch.zeros(shape, device=dev))
        self.register_buffer("max_val", torch.zeros(shape, device=dev))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool, device=dev))
        self.register_buffer("scale", torch.ones(shape, device=dev))
        self.register_buffer("zero_point", torch.zeros(shape, device=dev))

    @torch.no_grad()
    def observe(self, x: torch.Tensor) -> None:
        """Update min/max from a batch."""
        state = MinMaxState(self.min_val, self.max_val, self.initialized)
        if self.observer == "minmax":
            state = minmax_update(state, x, self.axes)
        else:
            state = ema_minmax_update(state, x, self.axes, self.momentum)
        self.min_val.copy_(state.min_val)
        self.max_val.copy_(state.max_val)
        self.initialized.copy_(state.initialized)

    @torch.no_grad()
    def update_qparams(self) -> None:
        """Refresh scale/zero_point from the observer state."""
        qparams = symmetric_qparams if self.symmetric else asymmetric_qparams
        scale, zp = qparams(self.min_val, self.max_val, self.qmin, self.qmax)
        self.scale.copy_(scale)
        self.zero_point.copy_(zp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits == 32:
            return x
        if self.bits == 1:
            raise ValueError("1-bit is not supported by the IAO path; use wbwtab")
        if self.training and not self.qaft:
            if not self.union:
                self.observe(x)
            self.update_qparams()
        return fake_quant(x, self.scale, self.zero_point, self.qmin, self.qmax,
                          self.min_val, self.max_val, self.symmetric)


def _act_quantizer(cfg: QuantConfig, dev) -> FakeQuantizer:
    """Activation quantizer: per-tensor EMA min/max."""
    if cfg.ptq:
        raise NotImplementedError(f"ptq=True is {_NOT_PORTED}")
    return FakeQuantizer(cfg.a_bits, symmetric=cfg.symmetric, observer="ema",
                         qaft=cfg.qaft, device=dev)


def _weight_quantizer(cfg: QuantConfig, stat_shape, axes, dev) -> FakeQuantizer:
    """Weight quantizer: min/max or EMA by ``weight_observer``,
    per-channel (``stat_shape``/``axes``) or per-layer by ``q_level``."""
    if cfg.q_level != 0:
        stat_shape, axes = (1,), None
    return FakeQuantizer(cfg.w_bits, symmetric=cfg.symmetric, is_weight=True,
                         stat_shape=stat_shape, axes=axes,
                         observer="minmax" if cfg.weight_observer == 0 else "ema",
                         qaft=cfg.qaft, device=dev)


class QuantConv2d(Conv2d):
    """Conv2d with fake-quantized input and weight.
    ``quant_inference=True`` skips the weight fake-quant (the weights were
    pre-quantized by ``pre_quantize_weights``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
                 groups: int = 1, bias: bool = True, *, cfg: QuantConfig,
                 device: Device = None, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, bias, device=device, generator=generator)
        dev = self.weight.device
        self.quant_inference = cfg.quant_inference
        self.activation_quantizer = _act_quantizer(cfg, dev)
        self.weight_quantizer = _weight_quantizer(cfg, (out_channels, 1, 1, 1), (1, 2, 3), dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else self.weight_quantizer(self.weight)
        return F.conv2d(self.activation_quantizer(x), w, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


def _per_out(v: torch.Tensor) -> torch.Tensor:
    """(O,) -> (O, 1, 1, 1), broadcasting over an OIHW kernel."""
    return v[:, None, None, None]


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """(C,) -> (C, 1, 1), broadcasting over an NCHW activation."""
    return v[:, None, None]


class QuantBNFuseConv2d(Conv2d):
    """Conv + BN fused during training.

    Training (not ``qaft``): a float conv gives the pre-BN output, whose
    batch mean and unbiased variance (``* n / (n - 1)``) update the
    running statistics (the first batch seeds them unless
    ``pretrained_model``); BN then folds into the conv:

    - ``bn_fuse_calib=False``: ``w' = w * gamma / sqrt(var_batch + eps)``,
      ``b' = beta + (b - mean_batch) * gamma / sqrt(var_batch + eps)``;
    - ``bn_fuse_calib=True``: the weights fold the just-updated running
      variance, and the output is corrected back to batch statistics,
      ``conv(q(x), q(w')) * sqrt(var_run + eps) / sqrt(var_batch + eps) + b'``.

    Eval / QAFT: fold the running statistics, one conv, no updates. The
    JAX package's ``bn_stats="acc"`` single-conv step is not ported.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
                 groups: int = 1, bias: bool = False, eps: float = 1e-5,
                 momentum: float = 0.1, *, cfg: QuantConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, bias, device=device, generator=generator)
        dev = self.weight.device
        self.eps = eps
        self.momentum = momentum
        self.pretrained_model = cfg.pretrained_model
        self.qaft = cfg.qaft
        self.bn_fuse_calib = cfg.bn_fuse_calib
        self.quant_inference = cfg.quant_inference
        self.gamma = nn.Parameter(torch.rand(out_channels, generator=generator, device=dev))
        self.beta = nn.Parameter(torch.zeros(out_channels, device=dev))
        self.register_buffer("running_mean", torch.zeros(out_channels, device=dev))
        self.register_buffer("running_var", torch.ones(out_channels, device=dev))
        self.register_buffer("bn_initialized", torch.zeros((), dtype=torch.bool, device=dev))
        self.activation_quantizer = _act_quantizer(cfg, dev)
        self.weight_quantizer = _weight_quantizer(cfg, (out_channels, 1, 1, 1), (1, 2, 3), dev)

    def _conv(self, x, w, b):
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation, self.groups)

    def _qconv(self, x, qw, b):
        return self._conv(self.activation_quantizer(x), qw, b)

    def _quant_w(self, w):
        return w if self.quant_inference else self.weight_quantizer(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b, gamma, beta = self.weight, self.bias, self.gamma, self.beta
        if self.training and not self.qaft:
            out_f = self._conv(x, w, b).to(torch.float32)
            batch_mean = torch.mean(out_f, dim=(0, 2, 3))
            n = out_f.shape[0] * out_f.shape[2] * out_f.shape[3]
            batch_var = torch.var(out_f, dim=(0, 2, 3), unbiased=False) * (n / max(n - 1, 1))
            m = self.momentum
            with torch.no_grad():
                sg_mean, sg_var = batch_mean.detach(), batch_var.detach()
                ema_mean = (1 - m) * self.running_mean + m * sg_mean
                ema_var = (1 - m) * self.running_var + m * sg_var
                if self.pretrained_model:
                    new_mean, new_var = ema_mean, ema_var
                else:
                    seeded = self.bn_initialized
                    new_mean = torch.where(seeded, ema_mean, sg_mean)
                    new_var = torch.where(seeded, ema_var, sg_var)
                    self.bn_initialized.fill_(True)
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
            inv_batch = gamma / F.sqrt(batch_var + self.eps)
            if b is not None:
                bias_fused = beta + (b - batch_mean) * inv_batch
            else:
                bias_fused = beta - batch_mean * inv_batch
            if not self.bn_fuse_calib:
                qw = self._quant_w(w * _per_out(inv_batch))
                return self._qconv(x, qw, bias_fused)
            qw = self._quant_w(w * _per_out(gamma / F.sqrt(new_var + self.eps)))
            out = self._qconv(x, qw, None)
            corr = F.sqrt(new_var + self.eps) / F.sqrt(batch_var + self.eps)
            return out * _per_channel(corr) + _per_channel(bias_fused)
        inv_run = gamma / F.sqrt(self.running_var + self.eps)
        if b is not None:
            bias_fused = beta + (b - self.running_mean) * inv_run
        else:
            bias_fused = beta - self.running_mean * inv_run
        return self._qconv(x, self._quant_w(w * _per_out(inv_run)), bias_fused)


class QuantLinear(Linear):
    """Linear with fake-quant; per-column weight observers when
    ``q_level == 0``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 cfg: QuantConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias, device=device, generator=generator)
        dev = self.weight.device
        self.quant_inference = cfg.quant_inference
        self.activation_quantizer = _act_quantizer(cfg, dev)
        self.weight_quantizer = _weight_quantizer(cfg, (1, out_features), (0,), dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else self.weight_quantizer(self.weight)
        return F.linear(self.activation_quantizer(x), w, self.bias)


class _QuantActBase(nn.Module):
    """Activation-only wrapper: fake-quantize the input, then the op."""

    def __init__(self, cfg: QuantConfig, device: Device = None):
        super().__init__()
        self.activation_quantizer = _act_quantizer(cfg, resolve_device(device))


class QuantReLU(_QuantActBase):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.activation_quantizer(x))


class QuantMaxPool2d(_QuantActBase):
    def __init__(self, kernel_size: IntPair, stride: Optional[IntPair] = None,
                 padding: IntPair = 0, *, cfg: QuantConfig, device: Device = None):
        super().__init__(cfg, device)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size
        self.padding = _pair(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.activation_quantizer(x), self.kernel_size, self.stride,
                            self.padding)


class QuantAvgPool2d(_QuantActBase):
    def __init__(self, kernel_size: IntPair, stride: Optional[IntPair] = None,
                 padding: IntPair = 0, *, cfg: QuantConfig, device: Device = None):
        super().__init__(cfg, device)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size
        self.padding = _pair(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.activation_quantizer(x), self.kernel_size, self.stride,
                            self.padding)


class QuantAdaptiveAvgPool2d(_QuantActBase):
    def __init__(self, output_size: IntPair, *, cfg: QuantConfig, device: Device = None):
        super().__init__(cfg, device)
        self.output_size = _pair(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(self.activation_quantizer(x), self.output_size)


class QuantAdd(nn.Module):
    """Residual add with one shared (union) scale: two observers watch
    the addends, the shared quantizer takes the union of their ranges,
    and both addends fake-quantize with it, so the integer add needs no
    rescale. Observers update only in training mode (and not ``qaft``),
    as in the JAX package."""

    def __init__(self, *, cfg: QuantConfig, device: Device = None):
        super().__init__()
        if cfg.ptq:
            raise NotImplementedError(f"ptq=True is {_NOT_PORTED}")
        dev = resolve_device(device)
        self.qaft = cfg.qaft
        self.observer_res = FakeQuantizer(cfg.a_bits, symmetric=True, qaft=cfg.qaft, device=dev)
        self.observer_shortcut = FakeQuantizer(cfg.a_bits, symmetric=True, qaft=cfg.qaft,
                                               device=dev)
        self.activation_quantizer = FakeQuantizer(cfg.a_bits, symmetric=cfg.symmetric,
                                                  qaft=cfg.qaft, union=True, device=dev)

    def forward(self, res: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        if self.training and not self.qaft:
            self.observer_res.observe(res)
            self.observer_shortcut.observe(shortcut)
            aq = self.activation_quantizer
            with torch.no_grad():
                aq.min_val.copy_(torch.minimum(self.observer_res.min_val,
                                               self.observer_shortcut.min_val))
                aq.max_val.copy_(torch.maximum(self.observer_res.max_val,
                                               self.observer_shortcut.max_val))
        return self.activation_quantizer(res) + self.activation_quantizer(shortcut)
