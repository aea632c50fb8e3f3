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

PTQ (``cfg.ptq``): activation quantizers observe with the percentile
histogram (``ptq_observer="percentile"``) or collect an |x| histogram for
the KL search of ``quant/calibrate.py`` (``"kl"``, the entropy observer);
PTQ forces symmetric quantizers. While an entropy quantizer streams (in
training mode, not ``qaft``) it passes its input through unquantized and
leaves its qparams alone: they exist only once calibration resolves them.

``QuantConvTranspose2d`` quantizes its weight per layer only, as the
JAX package does. ``QuantAdd`` and ``QuantConcat`` share one (union)
scale between their two inputs.

Training lowerings (``QuantConfig.act_codes`` and ``bn_stats``), resolved
at call time from the device of the input, since a model is built on one
device and may run on another: ``"auto"`` lowers a CUDA tensor and keeps
the exact f32 composition on the CPU; ``"on"``/``"off"`` force a
lowering, ``bn_stats="acc"`` the single-conv statistics. On the card the
code-storage convs read bf16 codes (exact up to 8 bits) and keep a bf16
output, as the JAX package's ``preferred_element_type=None`` does. A
lowering that cannot run raises; nothing falls back to the exact path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..quant.config import QuantConfig
from ..quant.observers import (EntropyState, HistogramState, MinMaxState, ema_minmax_update,
                               entropy_update, histogram_update, minmax_update)
from ..quant.quantizers import (asymmetric_qparams, fake_quant, fake_quant_codes, quant_range,
                                symmetric_qparams)
from . import functional as F
from .functional import IntPair, _pair
from .modules import Conv2d, ConvTranspose2d, Device, Linear, nchw_axis

__all__ = [
    "FakeQuantizer",
    "QuantConv2d",
    "QuantConvTranspose2d",
    "QuantBNFuseConv2d",
    "QuantLinear",
    "QuantReLU",
    "QuantLeakyReLU",
    "QuantSigmoid",
    "QuantMaxPool2d",
    "QuantAvgPool2d",
    "QuantAdaptiveAvgPool2d",
    "QuantAdd",
    "QuantConcat",
]

_OBSERVERS = ("minmax", "ema", "histogram", "entropy")


class FakeQuantizer(nn.Module):
    """One fake-quant chain: observer, qparams and clip-STE round.

    ``observer`` is ``"minmax"`` (cumulative), ``"ema"``, ``"histogram"``
    (EMA of the per-batch ``percentile`` of |x|) or ``"entropy"`` (an |x|
    histogram of ``entropy_bins`` bins in ``ent_counts``/``ent_absmax``,
    per-tensor only). ``union=True`` is ``QuantAdd``'s shared quantizer: it
    never observes (and carries no histogram), but refreshes its qparams
    each training step from the min/max assigned to it.
    """

    def __init__(self, bits: int, *, symmetric: bool = True, is_weight: bool = False,
                 stat_shape: Tuple[int, ...] = (1,), axes: Optional[Tuple[int, ...]] = None,
                 observer: str = "ema", momentum: float = 0.1, percentile: float = 0.9999,
                 qaft: bool = False, union: bool = False, entropy_bins: int = 2048,
                 device: Device = None):
        super().__init__()
        if observer not in _OBSERVERS:
            raise ValueError(f"observer {observer!r}; pick from {_OBSERVERS}")
        dev = resolve_device(device)
        self.bits = bits
        self.symmetric = symmetric
        self.is_weight = is_weight
        self.axes = None if axes is None else tuple(axes)
        self.observer = observer
        self.momentum = momentum
        self.percentile = percentile
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
        if observer == "entropy" and not union:
            # KL calibration is for activations, which are per-tensor
            if any(d != 1 for d in shape):
                raise ValueError("entropy (KL) calibration is per-tensor only: activation "
                                 f"quantizers are layer-level; got stat_shape={shape}")
            self.register_buffer("ent_counts", torch.zeros(entropy_bins, device=dev))
            self.register_buffer("ent_absmax", torch.zeros((), device=dev))

    @torch.no_grad()
    def observe(self, x: torch.Tensor) -> None:
        """Update the observer's statistics from a batch."""
        if self.observer == "entropy":
            est = entropy_update(EntropyState(self.ent_counts, self.ent_absmax,
                                              self.initialized), x)
            self.ent_counts.copy_(est.counts)
            self.ent_absmax.copy_(est.absmax)
            self.initialized.copy_(est.initialized)
            return
        if self.observer == "histogram":
            state = histogram_update(HistogramState(self.min_val, self.max_val,
                                                    self.initialized),
                                     x, self.percentile, self.momentum)
        else:
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
        """Refresh scale/zero_point from the observer state. The buffers are
        rebound to the new tensors, not written in place: a forward that
        quantizes twice (``QuantAdd``'s two addends) keeps the scale its
        first use saved for the backward."""
        qparams = symmetric_qparams if self.symmetric else asymmetric_qparams
        self.scale, self.zero_point = qparams(self.min_val, self.max_val, self.qmin, self.qmax)

    def _check_bits_and_update(self, x: torch.Tensor) -> bool:
        """Raise on 1 bit; in training mode (and not ``qaft``) update the
        observer and the qparams. Returns whether the quantizer streams."""
        if self.bits == 1:
            raise ValueError("1-bit is not supported by the IAO path; use wbwtab")
        streaming = self.training and not self.qaft
        if streaming:
            if not self.union:
                self.observe(x)
            if self.observer != "entropy":
                self.update_qparams()
        return streaming

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits == 32:
            return x
        if self._check_bits_and_update(x) and self.observer == "entropy":
            return x  # the float network streams until calibration resolves it
        return fake_quant(x, self.scale, self.zero_point, self.qmin, self.qmax,
                          self.min_val, self.max_val, self.symmetric)

    def codes(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(codes, scale, zero_point)`` with ``self(x) == (codes + zp) * s``
        bit for bit: the operand form of the code-storage lowering. Runs
        the same observer and qparam update as ``forward``; the codes carry
        the clip-STE gradient, scale and zero point none."""
        self._check_bits_and_update(x)
        c = fake_quant_codes(x, self.scale, self.zero_point, self.qmin, self.qmax,
                             self.min_val, self.max_val, self.symmetric)
        return c, self.scale.detach(), self.zero_point.detach()


def _ptq_observer(cfg: QuantConfig) -> str:
    return "entropy" if cfg.ptq_observer == "kl" else "histogram"


def _act_quantizer(cfg: QuantConfig, dev) -> FakeQuantizer:
    """Activation quantizer, per-tensor: EMA min/max in QAT; under PTQ the
    histogram or entropy observer, symmetric."""
    if cfg.ptq:
        return FakeQuantizer(cfg.a_bits, symmetric=True, observer=_ptq_observer(cfg),
                             percentile=cfg.percentile, qaft=cfg.qaft, device=dev)
    return FakeQuantizer(cfg.a_bits, symmetric=cfg.symmetric, observer="ema",
                         qaft=cfg.qaft, device=dev)


def _weight_quantizer(cfg: QuantConfig, stat_shape, axes, dev) -> FakeQuantizer:
    """Weight quantizer: min/max or EMA by ``weight_observer``,
    per-channel (``stat_shape``/``axes``) or per-layer by ``q_level``;
    symmetric under PTQ."""
    if cfg.q_level != 0:
        stat_shape, axes = (1,), None
    return FakeQuantizer(cfg.w_bits, symmetric=cfg.symmetric or cfg.ptq, is_weight=True,
                         stat_shape=stat_shape, axes=axes,
                         observer="minmax" if cfg.weight_observer == 0 else "ema",
                         qaft=cfg.qaft, device=dev)


def _auto_lowers(device: torch.device) -> bool:
    """Where ``"auto"`` takes the lowerings: a CUDA tensor."""
    return device.type == "cuda"


def _act_codes_enabled(cfg: QuantConfig, device: torch.device) -> bool:
    """Whether a layer of ``cfg`` runs the code-storage lowering on a
    tensor of ``device``. Never above 8 bits (codes must be exact in
    bf16), at 1 or 32 bits, or under PTQ (KL calibration needs the float
    activations); else ``"on"``/``"off"`` force it and ``"auto"`` takes it
    on CUDA."""
    if cfg.a_bits > 8 or cfg.a_bits in (1, 32) or cfg.ptq:
        return False
    if cfg.act_codes in ("on", "off"):
        return cfg.act_codes == "on"
    return _auto_lowers(device)


def _codes_dtype(device: torch.device) -> torch.dtype:
    """The code operands' dtype: bf16 on CUDA, f32 on the CPU."""
    return torch.bfloat16 if _auto_lowers(device) else torch.float32


def _acc_stats_enabled(cfg: QuantConfig, device: torch.device) -> bool:
    """Whether ``QuantBNFuseConv2d`` takes its batch statistics from the
    quantized conv's accumulator (``bn_stats="acc"``). That needs
    ``q(w * s) == q(w) * s`` for a per-channel ``s``, which holds for
    per-channel (``q_level == 0``) symmetric (``q_type == 0``) weight
    quantizers only; other configs keep the statistics conv. ``"auto"``
    takes it on CUDA."""
    if cfg.q_level != 0 or cfg.q_type != 0:
        return False
    return cfg.bn_stats == "acc" or (cfg.bn_stats == "auto" and _auto_lowers(device))


def _bf16_stats_enabled(cfg: QuantConfig, device: torch.device) -> bool:
    """Whether the statistics conv runs in bf16: ``"on"`` on every
    device, ``"auto"`` on CUDA where the acc statistics do not apply."""
    if cfg.bn_stats in ("on", "off", "acc"):
        return cfg.bn_stats == "on"
    return _auto_lowers(device) and not _acc_stats_enabled(cfg, device)


def _codes_apply(aq: FakeQuantizer, x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], dtype: torch.dtype, contract) -> torch.Tensor:
    """The quantized contraction over activation codes. With
    ``qx = s * (c + zp)``, ``contract(qx, w) = s * (contract(c, w) + zp *
    contract(ones, w))``: the contraction runs in the operand ``dtype``
    and its output stays in it, the zero-point term (a batch-1
    contraction of ones, which keeps the padding's edge effects) is added
    in it, then the cast to f32, the multiply by ``s`` and ``bias``
    (already shaped to broadcast over the output)."""
    c, s, zp = aq.codes(x)
    wd = w.to(dtype)
    out = contract(c.to(dtype), wd)
    if not aq.symmetric:
        ones = torch.ones((1,) + tuple(x.shape[1:]), dtype=dtype, device=x.device)
        out = out + zp.reshape(()).to(out.dtype) * contract(ones, wd)
    out = out.to(torch.float32) * s.reshape(())
    return out if bias is None else out + bias


def _bias_nchw(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if bias is None else bias[:, None, None]


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
        self.cfg = cfg
        self.quant_inference = cfg.quant_inference
        self.activation_quantizer = _act_quantizer(cfg, dev)
        self.weight_quantizer = _weight_quantizer(cfg, (out_channels, 1, 1, 1), (1, 2, 3), dev)

    def _contract(self, a, k):
        return F.conv2d(a, k, None, self.stride, self.padding, self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else self.weight_quantizer(self.weight)
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_apply(self.activation_quantizer, x, w, _bias_nchw(self.bias),
                                _codes_dtype(x.device), self._contract)
        return F.conv2d(self.activation_quantizer(x), w, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class QuantConvTranspose2d(ConvTranspose2d):
    """ConvTranspose2d with fake-quantized input and weight; the weight's
    quantizer is per layer whatever ``q_level`` says."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, output_padding: IntPair = 0,
                 groups: int = 1, bias: bool = True, dilation: IntPair = 1, *,
                 cfg: QuantConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, groups, bias, dilation, device=device,
                         generator=generator)
        dev = self.weight.device
        self.cfg = cfg
        self.quant_inference = cfg.quant_inference
        self.activation_quantizer = _act_quantizer(cfg, dev)
        self.weight_quantizer = _weight_quantizer(dataclasses.replace(cfg, q_level=1), (1,),
                                                  None, dev)

    def _contract(self, a, k):
        return F.conv_transpose2d(a, k, None, self.stride, self.padding, self.output_padding,
                                  self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else self.weight_quantizer(self.weight)
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_apply(self.activation_quantizer, x, w, _bias_nchw(self.bias),
                                _codes_dtype(x.device), self._contract)
        return F.conv_transpose2d(self.activation_quantizer(x), w, self.bias, self.stride,
                                  self.padding, self.output_padding, self.dilation,
                                  self.groups)


def _per_out(v: torch.Tensor) -> torch.Tensor:
    """(O,) -> (O, 1, 1, 1), broadcasting over an OIHW kernel."""
    return v[:, None, None, None]


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """(C,) -> (C, 1, 1), broadcasting over an NCHW activation."""
    return v[:, None, None]


def _fold_bias(beta, b, mean, inv):
    """The folded bias ``beta + (b - mean) * inv`` (``b`` may be None)."""
    return beta - mean * inv if b is None else beta + (b - mean) * inv


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

    Under ``bn_stats`` the statistics conv runs in bf16 (its output feeds
    only the f32 reductions; the bias folds into the mean), or, with
    ``"acc"``, not at all: the weights fold the running statistics from
    before the update, and the batch statistics are those of the one
    quantized conv's accumulator divided back by the fold (a documented
    deviation: they see the quantized operands). Its output rescales that
    accumulator to the batch fold, which serves both ``bn_fuse_calib``
    modes.

    Eval / QAFT: fold the running statistics, one conv, no updates.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
                 groups: int = 1, bias: bool = False, eps: float = 1e-5,
                 momentum: float = 0.1, *, cfg: QuantConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, bias, device=device, generator=generator)
        dev = self.weight.device
        self.cfg = cfg
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
        """The quantized conv, through the codes where the lowering applies;
        ``b`` is per out channel."""
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_apply(self.activation_quantizer, x, qw, _bias_nchw(b),
                                _codes_dtype(x.device),
                                lambda a, k: self._conv(a, k, None))
        return self._conv(self.activation_quantizer(x), qw, b)

    def _quant_w(self, w):
        return w if self.quant_inference else self.weight_quantizer(w)

    @staticmethod
    def _unbiased_var(out: torch.Tensor) -> torch.Tensor:
        n = out.shape[0] * out.shape[2] * out.shape[3]
        return torch.var(out.to(torch.float32), dim=(0, 2, 3), unbiased=False) * (
            n / max(n - 1, 1))

    @torch.no_grad()
    def _update_running(self, batch_mean, batch_var):
        """EMA of the running statistics (the first batch seeds them unless
        ``pretrained_model``); returns the new (mean, var)."""
        m = self.momentum
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
        return new_mean, new_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b, gamma, beta = self.weight, self.bias, self.gamma, self.beta
        if self.training and not self.qaft and _acc_stats_enabled(self.cfg, x.device):
            return self._forward_acc_stats(x, w, b, gamma, beta)
        if self.training and not self.qaft:
            if _bf16_stats_enabled(self.cfg, x.device):
                # the statistics conv's output feeds only the reductions: bf16
                # operands and output, f32 sums, the bias folded into the mean
                out_f = self._conv(x.to(torch.bfloat16), w.to(torch.bfloat16), None)
                batch_mean = torch.mean(out_f, dim=(0, 2, 3), dtype=torch.float32)
                if b is not None:
                    batch_mean = batch_mean + b
            else:
                out_f = self._conv(x, w, b).to(torch.float32)
                batch_mean = torch.mean(out_f, dim=(0, 2, 3))
            batch_var = self._unbiased_var(out_f)
            _, new_var = self._update_running(batch_mean, batch_var)
            inv_batch = gamma / F.sqrt(batch_var + self.eps)
            bias_fused = _fold_bias(beta, b, batch_mean, inv_batch)
            if not self.bn_fuse_calib:
                qw = self._quant_w(w * _per_out(inv_batch))
                return self._qconv(x, qw, bias_fused)
            qw = self._quant_w(w * _per_out(gamma / F.sqrt(new_var + self.eps)))
            out = self._qconv(x, qw, None)
            corr = F.sqrt(new_var + self.eps) / F.sqrt(batch_var + self.eps)
            return out * _per_channel(corr) + _per_channel(bias_fused)
        inv_run = gamma / F.sqrt(self.running_var + self.eps)
        bias_fused = _fold_bias(beta, b, self.running_mean, inv_run)
        return self._qconv(x, self._quant_w(w * _per_out(inv_run)), bias_fused)

    def _forward_acc_stats(self, x, w, b, gamma, beta):
        """One conv a training step (``bn_stats="acc"``). With per-channel
        symmetric weights ``q(w * s) == q(w) * s``, so the accumulator of
        ``conv(q(x), q(w * inv_run))`` (the fold of the running statistics
        before the update) is the pre-BN output times ``inv_run``: the
        batch statistics are its own divided back (``|inv_run|`` floored
        at 1e-12, so a gamma near 0 stays finite), and rescaling it by
        ``sqrt(var_run + eps) / sqrt(var_batch + eps)`` gives the batch
        fold."""
        eps = self.eps
        run_var = self.running_var.clone()
        inv_run = gamma / F.sqrt(run_var + eps)
        safe = torch.where(inv_run.abs() < 1e-12, 1e-12, inv_run)
        acc = self._qconv(x, self.weight_quantizer(w * _per_out(inv_run)), None)
        batch_mean = torch.mean(acc, dim=(0, 2, 3), dtype=torch.float32) / safe
        if b is not None:
            batch_mean = batch_mean + b
        batch_var = self._unbiased_var(acc) / torch.square(safe)
        self._update_running(batch_mean, batch_var)
        bias_fused = _fold_bias(beta, b, batch_mean, gamma / F.sqrt(batch_var + eps))
        corr = F.sqrt(run_var + eps) / F.sqrt(batch_var + eps)
        return acc * _per_channel(corr) + _per_channel(bias_fused)


class QuantLinear(Linear):
    """Linear with fake-quant; per-column weight observers when
    ``q_level == 0``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 cfg: QuantConfig, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias, device=device, generator=generator)
        dev = self.weight.device
        self.cfg = cfg
        self.quant_inference = cfg.quant_inference
        self.activation_quantizer = _act_quantizer(cfg, dev)
        self.weight_quantizer = _weight_quantizer(cfg, (1, out_features), (0,), dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.quant_inference else self.weight_quantizer(self.weight)
        if _act_codes_enabled(self.cfg, x.device):
            return _codes_apply(self.activation_quantizer, x, w, self.bias,
                                _codes_dtype(x.device), torch.matmul)
        return F.linear(self.activation_quantizer(x), w, self.bias)


class _QuantActBase(nn.Module):
    """Activation-only wrapper: fake-quantize the input, then the op."""

    def __init__(self, cfg: QuantConfig, device: Device = None):
        super().__init__()
        self.activation_quantizer = _act_quantizer(cfg, resolve_device(device))


class QuantReLU(_QuantActBase):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.activation_quantizer(x))


class QuantLeakyReLU(_QuantActBase):
    def __init__(self, negative_slope: float = 0.01, *, cfg: QuantConfig,
                 device: Device = None):
        super().__init__(cfg, device)
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.activation_quantizer(x), self.negative_slope)


class QuantSigmoid(_QuantActBase):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.activation_quantizer(x))


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


class _UnionQuant(nn.Module):
    """Two inputs, one shared (union) scale: a side observer watches each
    input, the shared quantizer takes the union of their ranges, and both
    inputs fake-quantize with it, so the integer op needs no rescale.
    Observers update only in training mode (and not ``qaft``), as in the
    JAX package. ``_SIDES`` names the two observers."""

    _SIDES: Tuple[str, str]

    def __init__(self, cfg: QuantConfig, device: Device):
        super().__init__()
        dev = resolve_device(device)
        self.qaft = cfg.qaft
        kw = dict(observer=_ptq_observer(cfg) if cfg.ptq else "ema",
                  percentile=cfg.percentile, qaft=cfg.qaft, device=dev)
        for side in self._SIDES:
            setattr(self, side, FakeQuantizer(cfg.a_bits, symmetric=True, **kw))
        self.activation_quantizer = FakeQuantizer(cfg.a_bits, symmetric=cfg.symmetric or cfg.ptq,
                                                  union=True, **kw)

    def sides(self) -> Tuple[FakeQuantizer, FakeQuantizer]:
        return tuple(getattr(self, side) for side in self._SIDES)

    def _quantize_both(self, a: torch.Tensor, b: torch.Tensor):
        if self.training and not self.qaft:
            sa, sb = self.sides()
            sa.observe(a)
            sb.observe(b)
            aq = self.activation_quantizer
            with torch.no_grad():
                aq.min_val.copy_(torch.minimum(sa.min_val, sb.min_val))
                aq.max_val.copy_(torch.maximum(sa.max_val, sb.max_val))
        return self.activation_quantizer(a), self.activation_quantizer(b)


class QuantAdd(_UnionQuant):
    """Residual add with one shared (union) scale."""

    _SIDES = ("observer_res", "observer_shortcut")

    def __init__(self, *, cfg: QuantConfig, device: Device = None):
        super().__init__(cfg, device)

    def forward(self, res: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        qa, qb = self._quantize_both(res, shortcut)
        return qa + qb


class QuantConcat(_UnionQuant):
    """Concatenation with one shared (union) scale, so the integer concat
    is a copy. ``axis`` is the JAX package's NHWC axis, as in
    :class:`..modules.Concat`."""

    _SIDES = ("observer_a", "observer_b")

    def __init__(self, axis: int = -1, *, cfg: QuantConfig, device: Device = None):
        super().__init__(cfg, device)
        self.axis = axis

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        qa, qb = self._quantize_both(a, b)
        return torch.cat([qa, qb], dim=nchw_axis(self.axis, qa.dim()))
