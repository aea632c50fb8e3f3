"""Integer inference engine: the counterpart of
``micronet_tpu/infer/engine.py`` (symmetric paths).

``freeze_int`` turns a BN-fused, weight-pre-quantized model (from
:func:`..infer.fuse_bn_iao`) into integer layers holding int8 weights
``round(w / s_w)``, their scales, and the activation scale. Activations
quantize to int8 on the fly, products accumulate exactly in int32, and
an f32 epilogue dequantizes and adds the bias, or requantizes straight
to the next layer's scale when the planner chains the two ("int8
chains": activations stay one byte between layers).

Convolutions run outside any hand-written kernel, as in the JAX package,
with exact integer accumulation:

- on the card, im2col over the int8 codes and ``torch._int_mm`` (cuBLAS
  int8 with int32 accumulators), one GEMM for every layer; a grouped
  conv runs as one GEMM over a block-diagonal weight;
- on the CPU, an f64 convolution over the codes (exact for every int32
  accumulator);
- the first layer (``groups == 1`` and fewer than 8 input channels per
  group) convolves the dequantized values in f32, as the JAX package
  does; on the card as im2col and one f32 matmul with TF32 off for the
  call.

The JAX package's bf16-codes lowering is a TPU choice; here both integer
routes are exact at any window size. ``IntLinear`` runs the hand-written
kernel K1 (``ops/int_matmul.py::int8_matmul_dequant``).

The wbwtab engine (``freeze_wbwtab``) turns each binary-range conv into a
:class:`TernaryConv2d`: its {-1, +1} inputs cast to int8 exactly and run
through the same two integer routes as ``IntConv2d`` (a cuDNN conv over
+-1 values would not be exact: its algorithm choice, Winograd or FFT,
rounds), then ``f32(acc) * alpha + bias``.

Not ported yet: the asymmetric (``q_type=1``) paths (``freeze_int``
raises), ``IntConcat``, ``IntConvTranspose2d``, and the JAX package's
``pallas_pointwise`` and ``pointwise_dot`` options.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as TF
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from ..nn import modules as M
from ..nn import qat_iao, qat_wbwtab
from ..nn.transform import _children, _copy_model
from ..ops.int4_matmul import pack_int4, unpack_int4
from ..ops.int_matmul import int8_linear
from ..quant.rounding import round_half_away

__all__ = ["IntConv2d", "IntLinear", "IntMaxPool2d", "IntAvgPool2d", "IntAdd", "freeze_int",
           "TernaryConv2d", "freeze_wbwtab"]


def _scalar_buffer(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).reshape(()).clone().to(dev)


def _requant(out: torch.Tensor, scale: torch.Tensor, qmin: float, qmax: float) -> torch.Tensor:
    return torch.clamp(round_half_away(out / scale), qmin, qmax).to(torch.int8)


def _quantize_weight_int8(w: torch.Tensor, scale: torch.Tensor, qmin: float = -127.0,
                          qmax: float = 127.0) -> torch.Tensor:
    return torch.clamp(round_half_away(w / scale), qmin, qmax).to(torch.int8)


@contextlib.contextmanager
def _no_tf32():
    """Matmuls and cuDNN convolutions in full f32 for the duration of the
    call."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _pad_to(n: int) -> int:
    """The next size ``torch._int_mm`` takes on the card: a multiple of 8,
    at least 16."""
    return max(16, -(-n // 8) * 8)


def _int_mm_exact(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32 with cuBLAS int8 on the
    card. K and N pad with zero codes (which add nothing) and M with zero
    rows, to the sizes the library takes."""
    m, k = a.shape
    n = b_t.shape[0]
    kp, np_, mp = _pad_to(k), _pad_to(n), max(m, 17)
    if kp != k or mp != m:
        a = TF.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np_ != n:
        b_t = TF.pad(b_t, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), b_t.contiguous().t())[:m, :n]


class _IntConvRoutes(nn.Module):
    """The exact integer accumulation of a conv over int8 codes, shared by
    :class:`IntConv2d` and :class:`TernaryConv2d`. A subclass sets
    ``w_shape`` (O, cg, kh, kw), ``stride``, ``padding``, ``dilation``,
    ``groups`` and ``_gemm_cache``, and defines ``_codes`` (the stored
    weight buffer) and ``_weights_hwio``."""

    def _codes(self) -> torch.Tensor:
        raise NotImplementedError

    def _weights_hwio(self) -> torch.Tensor:
        raise NotImplementedError

    def _weights(self) -> torch.Tensor:
        """OIHW int8 codes."""
        return self._weights_hwio().permute(3, 2, 0, 1)

    def _gemm_weight(self) -> torch.Tensor:
        """(O, kh*kw*C) int8: row o holds output channel o's codes in im2col
        (kh, kw, c) order over ALL input channels, zero outside its group.
        Built once and kept until the stored codes move or are written in
        place."""
        codes = self._codes()
        key = (codes.data_ptr(), codes.device, codes._version)
        if self._gemm_cache is not None and self._gemm_cache[0] == key:
            return self._gemm_cache[1]
        co, cg, kh, kw = self.w_shape
        g = self.groups
        og = co // g
        w = self._weights_hwio().permute(3, 0, 1, 2)  # (O, kh, kw, cg)
        full = torch.zeros((g, og, kh, kw, g, cg), dtype=torch.int8, device=w.device)
        for i in range(g):
            full[i, :, :, :, i, :] = w[i * og:(i + 1) * og]
        full = full.reshape(co, kh * kw * g * cg)
        self._gemm_cache = (key, full)
        return full

    def _im2col(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
        """(N, C, H, W) -> the (N*Ho*Wo, kh*kw*C) patch matrix in (kh, kw, c)
        column order, and (N, Ho, Wo). Padding is zero codes."""
        n, c, h, w = x.shape
        _, _, kh, kw = self.w_shape
        (sh, sw), (ph, pw), (dh, dw) = self.stride, self.padding, self.dilation
        xh = x.permute(0, 2, 3, 1)  # NHWC
        if ph or pw:
            xh = TF.pad(xh, (0, 0, pw, pw, ph, ph))
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        if (kh, kw) == (1, 1):
            return xh[:, ::sh, ::sw][:, :ho, :wo].reshape(n * ho * wo, c), (n, ho, wo)
        p = xh.unfold(1, dh * (kh - 1) + 1, sh).unfold(2, dw * (kw - 1) + 1, sw)
        p = p[..., ::dh, ::dw]  # (N, Ho, Wo, C, kh, kw)
        return p.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * c), (n, ho, wo)

    def _int_acc_im2col(self, x_q: torch.Tensor) -> torch.Tensor:
        cols, (n, ho, wo) = self._im2col(x_q)
        acc = _int_mm_exact(cols, self._gemm_weight())
        return acc.reshape(n, ho, wo, self.w_shape[0]).permute(0, 3, 1, 2)

    def int_acc(self, x_q: torch.Tensor) -> torch.Tensor:
        """The exact accumulator of the codes ``x_q`` (N, C, H, W) int8:
        int32 on the card (im2col + ``torch._int_mm``), f64 on the CPU (an
        f64 convolution), both exact."""
        if x_q.device.type == "cuda":
            return self._int_acc_im2col(x_q)
        return TF.conv2d(x_q.to(torch.float64), self._weights().to(torch.float64), None,
                         self.stride, self.padding, self.dilation, self.groups)


class IntConv2d(_IntConvRoutes):
    """Integer conv: int8 in, int8 weights, exact int32-valued
    accumulation, f32 epilogue (or a requant to int8 when chained).
    ``w_q`` is OIHW; with W <= 4 it is stored nibble-packed
    (``w_packed``) as the (kh*kw*cg/2, O) bytes of the JAX package."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, act_scale, bias,
                 stride: Tuple[int, int], padding: Tuple[int, int],
                 dilation: Tuple[int, int], groups: int, a_qmin: float, a_qmax: float):
        super().__init__()
        dev = w_q.device
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale.to(torch.float32).clone())
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("bias", None if bias is None else bias.clone())
        self.register_buffer("out_scale", torch.ones((), device=dev))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.a_qmin, self.a_qmax = a_qmin, a_qmax
        self.symmetric = a_qmin < 0
        # set by the chain planner: requantize the output to the next
        # layer's activation scale
        self.chained = False
        self.out_qmin, self.out_qmax = -128.0, 127.0
        self.w_shape = tuple(w_q.shape)  # (O, cg, kh, kw)
        self.w_packed = False
        # the image-input layer: f32 conv over the dequantized codes
        self.f32_dequant = groups == 1 and self.w_shape[1] < 8
        self._gemm_cache: Optional[Tuple[Tuple, torch.Tensor]] = None

    def _codes(self) -> torch.Tensor:
        return self.w_q

    def _weights_hwio(self) -> torch.Tensor:
        """(kh, kw, cg, O) int8 codes."""
        co, cg, kh, kw = self.w_shape
        if self.w_packed:
            return unpack_int4(self.w_q).reshape(kh, kw, cg, co)
        return self.w_q.permute(2, 3, 1, 0)

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        if not self.chained:
            return out
        return _requant(out, self.out_scale, self.out_qmin, self.out_qmax)

    def dequant_conv(self, x_q: torch.Tensor) -> torch.Tensor:
        """The first layer's route: f32 conv over the dequantized codes. On
        the card it is im2col and one f32 matmul with TF32 off for the call
        (FMA sums in a fixed order; no cuDNN algorithm choice)."""
        x_dq = x_q.to(torch.float32) * self.act_scale
        w_dq = self._weights().to(torch.float32) * self.w_scale[:, None, None, None]
        if x_dq.device.type != "cuda":
            return TF.conv2d(x_dq, w_dq, None, self.stride, self.padding, self.dilation,
                             self.groups)
        cols, (n, ho, wo) = self._im2col(x_dq)
        w_mat = w_dq.permute(0, 2, 3, 1).reshape(self.w_shape[0], -1)  # (O, kh*kw*C)
        with _no_tf32():
            out = cols @ w_mat.t()
        return out.reshape(n, ho, wo, -1).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s_x = self.act_scale
        if x.dtype == torch.int8:
            # chained: already quantized with this layer's scale upstream
            x_q = x
        else:
            x_q = torch.clamp(round_half_away(x.to(torch.float32) / s_x), self.a_qmin,
                              self.a_qmax).to(torch.int8)
        if self.f32_dequant:
            return self._finish(self.dequant_conv(x_q))
        acc = self.int_acc(x_q).to(torch.float32)
        return self._finish(acc * (s_x * self.w_scale)[:, None, None])


class IntLinear(nn.Module):
    """Integer linear on kernel K1 (``int8_linear``): w_q (in, out) int8,
    or nibble-packed (in/2, out) with W <= 4."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, act_scale, act_zero_point,
                 bias, a_qmin: float, a_qmax: float):
        super().__init__()
        dev = w_q.device
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale.to(torch.float32).clone())
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("act_zero_point", _scalar_buffer(act_zero_point, dev))
        self.register_buffer("bias", None if bias is None else bias.clone())
        self.a_qmin, self.a_qmax = a_qmin, a_qmax
        self.symmetric = a_qmin < 0
        self.w_packed = False
        self.w_shape = tuple(w_q.shape)

    def _weights(self) -> torch.Tensor:
        return unpack_int4(self.w_q) if self.w_packed else self.w_q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self._weights(), self.w_scale, self.act_scale,
                           self.act_zero_point, self.bias, qmin=self.a_qmin, qmax=self.a_qmax)


class IntMaxPool2d(nn.Module):
    """Frozen ``QuantMaxPool2d``: quantize (or take chained int8), max-pool
    the codes (order-preserving under a positive scale), then requantize
    to the next layer's scale or dequantize."""

    def __init__(self, kernel_size, stride, padding, act_scale):
        super().__init__()
        dev = act_scale.device
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("out_scale", torch.ones((), device=dev))
        self.chained = False
        self.a_qmin, self.a_qmax = -128.0, 127.0
        self.out_qmin, self.out_qmax = -128.0, 127.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.act_scale
        if x.dtype != torch.int8:
            x = torch.clamp(round_half_away(x.to(torch.float32) / s), self.a_qmin,
                            self.a_qmax).to(torch.int8)
        y = F.max_pool2d(x, self.kernel_size, self.stride, self.padding)
        if self.chained:
            q = round_half_away(y.to(torch.float32) * (s / self.out_scale))
            return torch.clamp(q, self.out_qmin, self.out_qmax).to(torch.int8)
        return y.to(torch.float32) * s


class IntAvgPool2d(nn.Module):
    """Frozen ``QuantAvgPool2d`` / ``QuantAdaptiveAvgPool2d``: quantize (or
    take chained int8) at its own scale, then average the dequantized
    values in f32. Receives chains, never emits one."""

    def __init__(self, kernel_size, stride, padding, act_scale, adaptive_size=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.adaptive_size = adaptive_size
        self.register_buffer("act_scale", _scalar_buffer(act_scale, act_scale.device))
        self.a_qmin, self.a_qmax = -128.0, 127.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.act_scale
        if x.dtype != torch.int8:
            x = torch.clamp(round_half_away(x.to(torch.float32) / s), self.a_qmin,
                            self.a_qmax).to(torch.int8)
        xf = x.to(torch.float32) * s
        if self.adaptive_size is not None:
            return F.adaptive_avg_pool2d(xf, self.adaptive_size)
        return F.avg_pool2d(xf, self.kernel_size, self.stride, self.padding)


class IntAdd(nn.Module):
    """Frozen ``QuantAdd``: both addends share one scale, so the codes add
    in int32 with no rescale; the result dequantizes or requantizes to
    the consumer's scale."""

    def __init__(self, act_scale, a_qmin: float, a_qmax: float):
        super().__init__()
        dev = act_scale.device
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("out_scale", torch.ones((), device=dev))
        self.a_qmin, self.a_qmax = a_qmin, a_qmax
        self.chained = False
        self.out_qmin, self.out_qmax = -128.0, 127.0

    def _inq(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.int8:
            return x
        return torch.clamp(round_half_away(x.to(torch.float32) / self.act_scale), self.a_qmin,
                           self.a_qmax).to(torch.int8)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = self.act_scale
        acc = self._inq(a).to(torch.int32) + self._inq(b).to(torch.int32)
        if self.chained:
            q = round_half_away(acc.to(torch.float32) * (s / self.out_scale))
            return torch.clamp(q, self.out_qmin, self.out_qmax).to(torch.int8)
        return acc.to(torch.float32) * s


def _check_bits(wq: qat_iao.FakeQuantizer, aq: qat_iao.FakeQuantizer) -> None:
    if wq.bits > 8 or aq.bits > 8 or 1 in (wq.bits, aq.bits):
        raise NotImplementedError(
            "int engine freezes 2..8-bit weights/activations (int8 storage; sub-8-bit "
            "values ride int8 with narrower clip ranges)")


@torch.no_grad()
def _freeze_conv(m: qat_iao.QuantConv2d) -> IntConv2d:
    wq, aq = m.weight_quantizer, m.activation_quantizer
    _check_bits(wq, aq)
    co = m.weight.shape[0]
    w_scale = torch.broadcast_to(wq.scale.reshape(-1), (co,))
    w_q = _quantize_weight_int8(m.weight, w_scale[:, None, None, None], wq.qmin, wq.qmax)
    out = IntConv2d(w_q, w_scale, aq.scale, m.bias, m.stride, m.padding, m.dilation,
                    m.groups, aq.qmin, aq.qmax)
    if wq.bits <= 4:
        _maybe_pack_w4(out, out._weights_hwio().reshape(-1, co))
    return out


@torch.no_grad()
def _freeze_linear(m: qat_iao.QuantLinear) -> IntLinear:
    wq, aq = m.weight_quantizer, m.activation_quantizer
    _check_bits(wq, aq)
    w_scale = torch.broadcast_to(wq.scale.reshape(-1), (m.weight.shape[1],))
    w_q = _quantize_weight_int8(m.weight, w_scale, wq.qmin, wq.qmax)
    out = IntLinear(w_q, w_scale, aq.scale, aq.zero_point, m.bias, aq.qmin, aq.qmax)
    if wq.bits <= 4:
        _maybe_pack_w4(out, w_q)
    return out


def _maybe_pack_w4(mod, w_q_2d: torch.Tensor) -> None:
    """Store W <= 4 codes nibble-packed (two a byte) when the flat
    contraction dim is even."""
    if w_q_2d.shape[0] % 2 == 0:
        mod.w_q = pack_int4(w_q_2d)
        mod.w_packed = True


def _freeze_maxpool(m: qat_iao.QuantMaxPool2d) -> IntMaxPool2d:
    aq = m.activation_quantizer
    pool = IntMaxPool2d(m.kernel_size, m.stride, m.padding, aq.scale)
    pool.a_qmin, pool.a_qmax = aq.qmin, aq.qmax
    return pool


def _freeze_avgpool(m) -> IntAvgPool2d:
    aq = m.activation_quantizer
    if isinstance(m, qat_iao.QuantAdaptiveAvgPool2d):
        pool = IntAvgPool2d(None, None, None, aq.scale, m.output_size)
    else:
        pool = IntAvgPool2d(m.kernel_size, m.stride, m.padding, aq.scale)
    # clip at the a_bits range, not the int8 storage range
    pool.a_qmin, pool.a_qmax = aq.qmin, aq.qmax
    return pool


def _freeze_add(m: qat_iao.QuantAdd) -> IntAdd:
    aq = m.activation_quantizer
    return IntAdd(aq.scale, aq.qmin, aq.qmax)


_FREEZERS = {
    qat_iao.QuantConv2d: _freeze_conv,
    qat_iao.QuantLinear: _freeze_linear,
    qat_iao.QuantMaxPool2d: _freeze_maxpool,
    qat_iao.QuantAvgPool2d: _freeze_avgpool,
    qat_iao.QuantAdaptiveAvgPool2d: _freeze_avgpool,
    qat_iao.QuantAdd: _freeze_add,
}


def freeze_int(model: nn.Module, *, inplace: bool = False, chain_int8: bool = True,
               example_input: Optional[torch.Tensor] = None, device=None) -> nn.Module:
    """Convert a BN-fused, weight-pre-quantized inference model to the
    integer engine, on ``device`` (None = CUDA, which raises without a
    card). Symmetric quantization at 2..8 bits, W <= 4 nibble-packed.

    With ``chain_int8`` the planner wires each emitter's requantizing
    epilogue to the next quantized layer's activation scale wherever only
    order-preserving modules (ReLU, MaxPool, Identity, Flatten) sit
    between them. Pass ``example_input`` (NHWC, batch may be 1) to trace
    the real dataflow, which branching graphs need: residual adds then
    chain through :class:`IntAdd`. Without it, a leaf-order fallback
    handles single-path graphs only.
    """
    dev = resolve_device(device)
    if any(isinstance(m, qat_iao.FakeQuantizer) and not m.symmetric
           for m in model.modules()):
        raise NotImplementedError(
            "asymmetric (q_type=1) engine paths are not ported yet "
            "(ROADMAP.md, Queue 1: asymmetric engine paths)")
    if not inplace:
        model = _copy_model(model)
    model.to(dev)

    def rec(module: nn.Module) -> None:
        for _, child, set_child in _children(module):
            freeze = _FREEZERS.get(type(child))
            if freeze is not None:
                set_child(freeze(child))
            else:
                rec(child)

    rec(model)
    if chain_int8 and example_input is not None:
        _plan_chains_dataflow(model, example_input[:1].to(dev))
    elif chain_int8:
        _plan_chains_leaf_order(model)
    return model


# passthrough modules between chain links, exact on symmetric int8 codes:
# ReLU keeps zero at code 0, max-pool is order-preserving, Identity and
# Flatten move memory only
_PASSTHROUGH = (M.ReLU, M.MaxPool2d, M.Identity, M.Flatten)


def _is_emitter(m) -> bool:
    """Emitters can requantize their output to a receiver's int8 scale."""
    return (isinstance(m, IntConv2d) and m.symmetric) or isinstance(m, (IntMaxPool2d, IntAdd))


def _is_receiver(m) -> bool:
    """Receivers accept chained int8 quantized at their own act_scale."""
    return (isinstance(m, IntConv2d) and m.symmetric) or isinstance(
        m, (IntMaxPool2d, IntAvgPool2d, IntAdd))


@torch.no_grad()
def _link(emitter, receiver) -> None:
    emitter.chained = True
    emitter.out_scale.copy_(receiver.act_scale)
    emitter.out_qmin = receiver.a_qmin
    emitter.out_qmax = receiver.a_qmax


def _plan_chains_leaf_order(model: nn.Module) -> None:
    """Chain along definition order. Only sound for single-path graphs (the
    last conv of a residual branch is followed in leaf order by a sibling
    branch's module, not by its consumer), so it does nothing on a graph
    with an add."""
    if any(isinstance(m, (IntAdd, qat_iao.QuantAdd)) for m in model.modules()):
        return
    ordered: list = []

    def collect(m: nn.Module) -> None:
        # leaves only: containers are transparent to execution order
        for _, child, _ in _children(m):
            if list(_children(child)):
                collect(child)
            else:
                ordered.append(child)

    collect(model)
    for i, cur in enumerate(ordered):
        if _is_emitter(cur):
            j = i + 1
            while j < len(ordered) and isinstance(ordered[j], _PASSTHROUGH):
                j += 1
            if j < len(ordered) and _is_receiver(ordered[j]):
                _link(cur, ordered[j])


def _plan_chains_dataflow(model: nn.Module, example_input: torch.Tensor) -> None:
    """Trace the real consumer graph and chain every emitter whose output
    feeds exactly one receiver (directly or through passthrough modules).
    Each producer into an IntAdd requantizes to the add's shared scale
    independently; an output that fans out to several consumers stays
    f32."""
    from .dataflow import trace_dataflow

    node_types = [
        IntConv2d, IntLinear, IntMaxPool2d, IntAvgPool2d, IntAdd,
        # unfrozen fake-quant layers are opaque f32 nodes: chains never
        # jump across them
        qat_iao.QuantConv2d, qat_iao.QuantLinear, qat_iao.QuantReLU,
        qat_iao.QuantMaxPool2d, qat_iao.QuantAvgPool2d, qat_iao.QuantAdaptiveAvgPool2d,
        qat_iao.QuantAdd,
    ] + list(_PASSTHROUGH)
    trace = trace_dataflow(model, example_input, node_types)
    consumers = trace.consumers()
    counts = trace.call_counts()

    def effective_receivers(m):
        """Non-passthrough consumers reached through passthrough modules;
        None when an output escapes the traced graph (then no chain)."""
        direct = consumers.get(id(m), [])
        if not direct:
            return None
        seen, out, stack = set(), [], list(direct)
        while stack:
            v = stack.pop()
            if id(v) in seen:
                continue
            seen.add(id(v))
            if isinstance(v, _PASSTHROUGH):
                nxt = consumers.get(id(v), [])
                if not nxt:
                    return None
                stack.extend(nxt)
            else:
                out.append(v)
        return out

    uniq = {}
    for mod, _ in trace.calls:
        uniq.setdefault(id(mod), mod)
    for m in uniq.values():
        # a module called more than once would need one scale per call
        if not _is_emitter(m) or counts[id(m)] != 1:
            continue
        recv = effective_receivers(m)
        if recv is None or len(recv) != 1 or recv[0] is m:
            continue
        if _is_receiver(recv[0]):
            _link(m, recv[0])


# --------------------------------------------------------------------------
# wbwtab (ternary/binary) engine
# --------------------------------------------------------------------------


class TernaryConv2d(_IntConvRoutes):
    """Integer execution of a wbwtab conv whose input is binary {-1, +1}.
    The weights are ``w_t * alpha``, ``w_t`` (OIHW int8) in {-1, 0, +1}
    and ``alpha`` (O,) f32 per out channel. The signs cast to int8
    exactly, the conv accumulates exactly (im2col + ``torch._int_mm`` on
    the card, an f64 conv on the CPU; the zero padding is code 0, as the
    float conv pads with 0), and the epilogue is ``f32(acc) * alpha``,
    then ``+ bias``, each rounded once."""

    def __init__(self, w_t: torch.Tensor, alpha: torch.Tensor, bias,
                 stride: Tuple[int, int], padding: Tuple[int, int],
                 dilation: Tuple[int, int], groups: int):
        super().__init__()
        self.register_buffer("w_t", w_t)
        self.register_buffer("alpha", alpha.to(torch.float32).clone())
        self.register_buffer("bias", None if bias is None else bias.clone())
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.w_shape = tuple(w_t.shape)  # (O, cg, kh, kw)
        self._gemm_cache: Optional[Tuple[Tuple, torch.Tensor]] = None

    def _codes(self) -> torch.Tensor:
        return self.w_t

    def _weights_hwio(self) -> torch.Tensor:
        return self.w_t.permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the inputs are exact +-1.0 (a sign, or a max-pool of signs)
        x_q = x if x.dtype == torch.int8 else x.to(torch.int8)
        out = self.int_acc(x_q).to(torch.float32) * self.alpha[:, None, None]
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out


@torch.no_grad()
def _freeze_ternary(conv: qat_wbwtab.QuantConv2d) -> TernaryConv2d:
    w = conv.weight  # t * alpha, alpha >= 0 per out channel
    alpha = torch.amax(torch.abs(w), dim=(1, 2, 3))
    w_t = round_half_away(w / torch.clamp(alpha, min=1e-12)[:, None, None, None])
    return TernaryConv2d(w_t.to(torch.int8), alpha, conv.bias, conv.stride, conv.padding,
                         conv.dilation, conv.groups)


def freeze_wbwtab(model: nn.Module, *, inplace: bool = False, device=None) -> nn.Module:
    """Convert a wbwtab BN-fused inference model (``fuse_bn_wbwtab``, its
    weights pre-quantized to ``t * alpha``) into the ternary engine on
    ``device`` (None = CUDA): every ``QuantConv2d(quant_inference=True)``
    becomes a :class:`TernaryConv2d`."""
    dev = resolve_device(device)
    if not inplace:
        model = _copy_model(model)
    model.to(dev)

    def rec(module: nn.Module) -> None:
        for _, child, set_child in _children(module):
            if type(child) is qat_wbwtab.QuantConv2d and child.quant_inference:
                set_child(_freeze_ternary(child))
            else:
                rec(child)

    rec(model)
    return model
