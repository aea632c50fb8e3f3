"""Integer inference engine: the counterpart of
``micronet_tpu/infer/engine.py``.

``freeze_int`` turns a BN-fused, weight-pre-quantized model (from
:func:`..infer.fuse_bn_iao`) into integer layers holding int8 weights
``round(w / s_w)``, their scales, and the activation scale and zero
point. Activations quantize to int8 on the fly, products accumulate
exactly in int32, and an f32 epilogue dequantizes and adds the bias, or
requantizes straight to the next layer's scale when the planner chains
the two ("int8 chains": activations stay one byte between layers).

Asymmetric (``q_type=1``) quantizers have unsigned codes: activations in
[0, 2^b - 1], weights in [0, 2^b - 2], with ``x_int = q0 + zp``. The
engine stores ``q0 - 128`` in int8 (b <= 8) and folds the shift ``128 +
zp`` into correction terms added to the f32 accumulator in the JAX
package's order: for a conv ``acc + (128 + zp) * conv(1, w)``, then ``+
(128 + zp_w) * sum_x`` (the window sum of each output's group), then ``+
(128 + zp) * (128 + zp_w) * count`` (the window's size); for a linear
``acc + sh_w * rowsum_x + sh_x * colsum_w + (K * sh_x) * sh_w``. An
asymmetric layer quantizes from f32 and writes f32: it neither emits nor
receives an int8 chain, and pools, adds and concats with an asymmetric
quantizer stay fake-quant, as in the JAX package.

Convolutions run outside any hand-written kernel, as in the JAX package,
with exact integer accumulation:

- on the card, im2col over the int8 codes and ``torch._int_mm`` (cuBLAS
  int8 with int32 accumulators), one GEMM for every layer; a grouped
  conv runs as one GEMM over a block-diagonal weight. The patch matrix
  is a view of the NHWC codes for a stride-1 1 x 1 conv, else one pass
  of a hand-written kernel (``ops/patch_gather.py::patch_matrix``) that
  reads the codes once and writes the GEMM's operand once. The correction
  terms are no GEMMs: ``conv(1, w)`` and ``count`` depend only on the
  input's spatial shape and come from one image of ones through the same
  route; ``sum_x`` is a row sum of the patch matrix the GEMM reads;
- on the CPU, f64 convolutions over the codes (exact for every int32
  accumulator), the correction terms as the JAX package computes them;
- a transposed conv is the convolution of the input dilated by
  ``stride`` and edge-padded by ``d * (k - 1) - p`` (cropped where that
  is negative, ``+ output_padding`` on the high side) with the flipped
  kernel, in and out swapped: on the card through the same im2col GEMM,
  on the CPU an f64 ``conv_transpose2d``;
- the first layer (``groups == 1`` and fewer than 8 input channels per
  group, symmetric) convolves the dequantized values in f32, as the JAX
  package does; on the card as im2col and one f32 matmul with TF32 off
  for the call, the patch kernel writing the dequantized patches.

A symmetric ``IntConv2d``'s epilogue (the accumulator's cast, scale and
bias, and the requant when chained) is one operator,
``ops/requant_epilogue.py::requant_epilogue``: on the card one pass of a
hand-written kernel over the GEMM's (M, O) rows, as XLA fuses the JAX
package's, on the CPU its plain twin; both give the chain's bits, which
every other layer runs.

A symmetric 3 x 3 depthwise ``IntConv2d`` (groups = C_in = C_out,
dilation 1: :attr:`IntConv2d.depthwise`) takes a route of its own, the
operator ``ops/dwconv.py::dwconv_int8``: on the card one hand-written
kernel computes the exact accumulator and the same epilogue, on the CPU
its twin (the f64 convolution, then the epilogue's twin). Its bits are
the block-diagonal route's, without its C-fold work. Every other grouped
conv keeps the block-diagonal GEMM.

The JAX package's bf16-codes lowering is a TPU choice; here both integer
routes are exact at any window size. A symmetric ``IntLinear`` runs the
hand-written kernel K1 (``ops/int_matmul.py::int8_matmul_dequant``); an
asymmetric one, as in the JAX package, a plain integer matmul
(``torch._int_mm`` on the card) with rank-1 corrections.

The wbwtab engine (``freeze_wbwtab``) turns each binary-range conv into a
:class:`TernaryConv2d`: its {-1, +1} inputs cast to int8 exactly and run
through the same two integer routes as ``IntConv2d`` (a cuDNN conv over
+-1 values would not be exact: its algorithm choice, Winograd or FFT,
rounds), then ``f32(acc) * alpha + bias``.

Every module records its work by role as spans (``utils/profiling.py``,
off by default): ``int.quantize`` (activation codes), ``int.im2col`` (the
patch matrix, the first layer's dequantized patches too), ``int.gemm``
(the integer products, the first layer's f32 matmul, K1),
``int.epilogue`` (the accumulator's cast, scale, bias, correction terms
and requant, on the card one kernel for a symmetric conv; the adds' and
concats' codes), ``int.dwconv`` (the depthwise route, its epilogue
included) and ``int.pool``. The models' channel shuffle, which no module
holds, records ``fn.shuffle`` (``nn/functional.py``; int8 codes on the
card take the patch gathers' shuffle kernel). They run in an eager
forward and in a CUDA graph's capture, not in its replay.

Not ported: the JAX package's ``pallas_pointwise`` and ``pointwise_dot``
options (TPU lowerings, off by default there).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional, Tuple

import torch
import torch.nn.functional as TF
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from ..nn import modules as M
from ..nn import qat_iao, qat_wbwtab
from ..nn.transform import _children, _copy_model
from ..ops.dwconv import dw_weight, dwconv_int8
from ..ops.int4_matmul import pack_int4, unpack_int4
from ..ops.int_matmul import int8_linear
from ..ops.patch_gather import out_hw, patch_matrix
from ..ops.requant_epilogue import requant, requant_epilogue
from ..quant.rounding import round_half_away
from ..utils.profiling import span

__all__ = ["IntConv2d", "IntConvTranspose2d", "IntLinear", "IntMaxPool2d", "IntAvgPool2d",
           "IntAdd", "IntConcat", "freeze_int", "TernaryConv2d", "freeze_wbwtab"]


def _scalar_buffer(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).reshape(()).clone().to(dev)


def _quantize_weight_int8(w: torch.Tensor, scale: torch.Tensor, qmin: float = -127.0,
                          qmax: float = 127.0) -> torch.Tensor:
    return requant(w, scale, qmin, qmax)


def _shifted_weight_codes(w: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
                          qmin: float, qmax: float) -> torch.Tensor:
    """Asymmetric weight codes ``clamp(round(w / s - zp_w), qmin, qmax)``
    stored as ``q0 - 128`` in int8."""
    q0 = torch.clamp(round_half_away(w / scale - zero_point), qmin, qmax)
    return (q0 - 128.0).to(torch.int8)


def _act_codes(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor, qmin: float,
               qmax: float, symmetric: bool) -> torch.Tensor:
    """int8 activation codes: ``clamp(round(x / s), qmin, qmax)``, or for
    an asymmetric quantizer ``q0 - 128`` with ``q0 = clamp(round(x / s) -
    zp, qmin, qmax)`` (the value is ``x_int = q0 + zp``)."""
    with span("int.quantize"):
        q = round_half_away(x.to(torch.float32) / scale)
        if symmetric:
            return torch.clamp(q, qmin, qmax).to(torch.int8)
        return (torch.clamp(q - zero_point, qmin, qmax) - 128.0).to(torch.int8)


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


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> an (N, H, W, C) view: contiguous for the card
    route's outputs, which permute a GEMM's (N*H*W, C) rows."""
    return t.permute(0, 2, 3, 1)


def _add_per_group(acc: torch.Tensor, coef: torch.Tensor, per_group: torch.Tensor) -> torch.Tensor:
    """``acc + coef[o] * per_group[g(o)]``: ``acc`` (N, H, W, O) f32,
    ``coef`` (O,), ``per_group`` (N or 1, H, W, G) integers, one value for
    all the output channels of a group. Each element is one f32 product
    and one f32 add, as the JAX package's repeated form computes it."""
    n, h, w, co = acc.shape
    g = per_group.shape[-1]
    term = coef.reshape(g, co // g) * per_group.to(torch.float32)[..., None]
    return (acc.reshape(n, h, w, g, co // g) + term).reshape(n, h, w, co)


class _IntConvRoutes(nn.Module):
    """The exact integer accumulation of a conv over int8 codes, shared by
    :class:`IntConv2d`, :class:`IntConvTranspose2d` and
    :class:`TernaryConv2d`. A subclass sets ``w_shape`` (O, cg, kh, kw) of
    the convolution the GEMM runs, ``stride``, ``padding``, ``dilation``,
    ``groups`` and ``_gemm_cache``, and defines ``_codes`` (the stored
    weight buffer), ``_weights_hwio`` (the GEMM's convolution kernel) and
    ``_f64`` (its own operation in f64, the CPU route)."""

    def _codes(self) -> torch.Tensor:
        raise NotImplementedError

    def _weights_hwio(self) -> torch.Tensor:
        raise NotImplementedError

    def _f64(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The layer's own operation in f64 on the codes ``x`` and the
        kernel ``w`` (in the layout of :meth:`_weights`)."""
        return TF.conv2d(x.to(torch.float64), w.to(torch.float64), None, self.stride,
                         self.padding, self.dilation, self.groups)

    def _weights(self) -> torch.Tensor:
        """The int8 kernel in torch's layout: OIHW."""
        return self._weights_hwio().permute(3, 2, 0, 1)

    def _ones_kernel(self, dev: torch.device) -> torch.Tensor:
        """The kernel of ones (in :meth:`_weights`'s layout) whose output is
        one window sum per group."""
        _, cg, kh, kw = self.w_shape
        return torch.ones((self.groups, cg, kh, kw), dtype=torch.int8, device=dev)

    def _gemm_geometry(self):
        """(stride, padding, dilation) of the convolution the GEMM runs."""
        return self.stride, self.padding, self.dilation

    def _gemm_input(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the convolution the GEMM runs."""
        return x

    def _cached(self, slot: str, build) -> torch.Tensor:
        """``build()``, a weight laid out from the stored codes, kept in the
        attribute ``slot`` until the codes move or are written in place.
        Under ``torch.export`` (fake tensors, no data pointer) it is built
        in the traced graph instead, from the codes the program embeds."""
        if torch.compiler.is_compiling():
            return build()
        codes = self._codes()
        key = (codes.data_ptr(), codes.device, codes._version)
        cache = getattr(self, slot)
        if cache is None or cache[0] != key:
            cache = (key, build())
            setattr(self, slot, cache)
        return cache[1]

    def _gemm_weight(self) -> torch.Tensor:
        """(O, kh*kw*C) int8: row o holds output channel o's codes in im2col
        (kh, kw, c) order over ALL input channels, zero outside its group
        (kept, :meth:`_cached`)."""
        return self._cached("_gemm_cache", self._build_gemm_weight)

    def _build_gemm_weight(self) -> torch.Tensor:
        co, cg, kh, kw = self.w_shape
        g = self.groups
        og = co // g
        w = self._weights_hwio().permute(3, 0, 1, 2)  # (O, kh, kw, cg)
        if g == 1:
            return w.reshape(co, kh * kw * cg).contiguous()
        full = torch.zeros((g, og, kh, kw, g, cg), dtype=torch.int8, device=w.device)
        for i in range(g):
            full[i, :, :, :, i, :] = w[i * og:(i + 1) * og]
        return full.reshape(co, kh * kw * g * cg)

    def _im2col(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
        """(N, C, H, W) codes -> the (N*Ho*Wo, kh*kw*C) patch matrix in (kh,
        kw, c) column order, and (N, Ho, Wo). Padding is zero codes; with
        ``scale`` the patches are ``float(code) * scale`` in f32. A stride-1
        1 x 1 conv's is a view of the NHWC codes; every other is one pass of
        ``ops/patch_gather.py::patch_matrix`` (the kernel on the card, its
        twin on the CPU)."""
        n, c, h, w = x.shape
        kernel = self.w_shape[2:]
        stride, padding, dilation = self._gemm_geometry()
        ho, wo = out_hw(h, w, kernel, stride, padding, dilation)
        view = scale is None and (tuple(kernel), tuple(stride), tuple(padding)) == (
            (1, 1), (1, 1), (0, 0))
        with span("int.im2col"):
            if view:
                return x.permute(0, 2, 3, 1).reshape(n * ho * wo, c), (n, ho, wo)
            return patch_matrix(x, kernel, stride, padding, dilation, scale), (n, ho, wo)

    def _int_acc_im2col(self, x_q: torch.Tensor, group_sums: bool = False):
        """The card's route (it runs on CPU tensors too): the accumulator
        as int32, and with ``group_sums`` each output position's window
        sum per group, (N, G, Ho, Wo) int32, from the same patch matrix."""
        cols, (n, ho, wo) = self._im2col(self._gemm_input(x_q))
        with span("int.gemm"):
            acc = _int_mm_exact(cols, self._gemm_weight())
            acc = acc.reshape(n, ho, wo, self.w_shape[0]).permute(0, 3, 1, 2)
        if not group_sums:
            return acc
        _, _, kh, kw = self.w_shape
        with span("int.epilogue"):
            sums = cols.reshape(cols.shape[0], kh * kw, self.groups, -1).sum(dim=(1, 3),
                                                                             dtype=torch.int32)
        return acc, sums.reshape(n, ho, wo, self.groups).permute(0, 3, 1, 2)

    def int_acc(self, x_q: torch.Tensor, group_sums: bool = False):
        """The exact accumulator of the codes ``x_q`` (N, C, H, W) int8, and
        with ``group_sums`` the window sums per group: int32 on the card
        (im2col + ``torch._int_mm``), f64 on the CPU (f64 convolutions),
        both exact."""
        if x_q.device.type == "cuda":
            return self._int_acc_im2col(x_q, group_sums)
        with span("int.gemm"):
            acc = self._f64(x_q, self._weights())
        if not group_sums:
            return acc
        with span("int.epilogue"):
            return acc, self._f64(x_q, self._ones_kernel(x_q.device))

    def _zero_point_acc(self, x_q: torch.Tensor) -> torch.Tensor:
        """The f32 accumulator of ``x_int . w_int``: the codes' product,
        then the zero-point terms in the JAX package's order. ``conv(1, w)``
        and ``count`` come from one image of ones (they depend on the
        spatial shape only). The terms are added channels last, the card
        route's own layout (a view of its GEMM's rows), and the result is
        an NCHW view of it."""
        if self.w_symmetric:
            acc = self.int_acc(x_q)
        else:
            acc, sum_x = self.int_acc(x_q, group_sums=True)
        with span("int.epilogue"):
            acc = acc.to(torch.float32)
        if self.symmetric and self.w_symmetric:
            return acc
        ones = torch.ones((1,) + tuple(x_q.shape[1:]), dtype=torch.int8, device=x_q.device)
        corr_w, count = self.int_acc(ones, group_sums=True)
        with span("int.epilogue"):
            sh_x = 128.0 + self.act_zero_point
            acc = _nhwc(acc)
            if not self.symmetric:
                acc = acc + sh_x * _nhwc(corr_w).to(torch.float32)
            if not self.w_symmetric:
                sh_w = (128.0 + self.w_zp).expand(self.w_shape[0])
                acc = _add_per_group(acc, sh_w, _nhwc(sum_x))
                if not self.symmetric:
                    acc = _add_per_group(acc, sh_x * sh_w, _nhwc(count))
            return acc.permute(0, 3, 1, 2)


@torch.no_grad()
def exact_zero_point_acc(layer: _IntConvRoutes, x_q: torch.Tensor):
    """For an :class:`IntConv2d` or :class:`IntConvTranspose2d` and its
    input codes ``x_q``: the exact value of its accumulator with the
    zero-point terms (f64, on the CPU), and a bound, per element, of how
    far its f32 sequence (the JAX package's order) can lie from it. That
    sequence rounds at most seven times (the accumulator's cast, three
    products, three sums), each by at most 2^-24 of a value no larger than
    the sum ``M`` of the four terms' magnitudes: the bound is ``7 * 2^-24
    * M``. With sub-8-bit codes stored near -128 and windows of thousands
    of codes the terms reach 1e8 and cancel to a small sum, so the
    rounding can reach units of the accumulator."""
    layer = copy.deepcopy(layer).cpu()
    x_q = x_q.cpu()
    acc, sum_x = layer.int_acc(x_q, group_sums=True)
    ones = torch.ones((1,) + tuple(x_q.shape[1:]), dtype=torch.int8)
    corr_w, count = layer.int_acc(ones, group_sums=True)
    co = layer.w_shape[0]
    og = co // layer.groups
    sh_x = 0.0 if layer.symmetric else 128.0 + float(layer.act_zero_point)
    sh_w = torch.zeros(co, dtype=torch.float64) if layer.w_symmetric else (
        128.0 + layer.w_zp.double()).expand(co)
    sh_w = sh_w[:, None, None]
    terms = (acc.double(), sh_x * corr_w.double(),
             sh_w * sum_x.double().repeat_interleave(og, dim=1),
             sh_x * sh_w * count.double().repeat_interleave(og, dim=1))
    exact = sum(terms)
    return exact, 7 * 2.0 ** -24 * sum(t.abs() for t in terms)


class IntConv2d(_IntConvRoutes):
    """Integer conv: int8 in, int8 weights, exact int32-valued
    accumulation, f32 epilogue (or a requant to int8 when chained), on the
    card one hand-written pass where activations and weights are
    symmetric.
    ``w_q`` is OIHW; with symmetric W <= 4 it is stored nibble-packed
    (``w_packed``) as the (kh*kw*cg/2, O) bytes of the JAX package.
    Asymmetric weights (``w_symmetric`` False) are stored ``q0 - 128``
    with their per-out-channel zero point ``w_zp``."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, act_scale, bias,
                 stride: Tuple[int, int], padding: Tuple[int, int],
                 dilation: Tuple[int, int], groups: int, a_qmin: float, a_qmax: float,
                 act_zero_point=0.0):
        super().__init__()
        dev = w_q.device
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale.to(torch.float32).clone())
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("act_zero_point", _scalar_buffer(act_zero_point, dev))
        self.register_buffer("w_zp", torch.zeros(w_q.shape[0], device=dev))
        self.register_buffer("bias", None if bias is None else bias.clone())
        self.register_buffer("out_scale", torch.ones((), device=dev))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.a_qmin, self.a_qmax = a_qmin, a_qmax
        self.symmetric = a_qmin < 0
        self.w_symmetric = True
        # set by the chain planner: requantize the output to the next
        # layer's activation scale
        self.chained = False
        self.out_qmin, self.out_qmax = -128.0, 127.0
        self.w_shape = tuple(w_q.shape)  # (O, cg, kh, kw)
        self.w_packed = False
        # the image-input layer: f32 conv over the dequantized codes
        # (symmetric activations and weights only)
        self.f32_dequant = groups == 1 and self.w_shape[1] < 8
        self._gemm_cache: Optional[Tuple[Tuple, torch.Tensor]] = None
        self._dw_cache: Optional[Tuple[Tuple, torch.Tensor]] = None

    @property
    def depthwise(self) -> bool:
        """Whether the conv takes the depthwise route (``ops/dwconv.py``):
        symmetric activations and weights, groups = C_in = C_out > 1, a
        3 x 3 kernel, dilation 1."""
        co, cg, kh, kw = self.w_shape
        return (self.symmetric and self.w_symmetric and self.groups > 1 and co == self.groups
                and cg == 1 and (kh, kw) == (3, 3) and tuple(self.dilation) == (1, 1))

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
        return requant(out, self.out_scale, self.out_qmin, self.out_qmax)

    def _epilogue(self, acc: torch.Tensor, w_scale: Optional[torch.Tensor]) -> torch.Tensor:
        """A symmetric conv's epilogue, :meth:`_finish` of ``acc * (s_x *
        w_scale)``, through ``ops/requant_epilogue.py::requant_epilogue``:
        on the card one pass of the hand-written kernel over the route's
        (M, O) rows (``acc`` an NCHW view of them: the int32 GEMM's, or
        with ``w_scale`` None the first layer's f32 one), on the CPU its
        twin, the same chain (``acc`` the exact f64 accumulator or the f32
        conv). The output is an NCHW view of (M, O) rows."""
        n, co, h, w = acc.shape
        out = requant_epilogue(_nhwc(acc).reshape(-1, co), self.act_scale, w_scale, self.bias,
                               self.out_scale, self.out_qmin, self.out_qmax, self.chained)
        return out.reshape(n, h, w, co).permute(0, 3, 1, 2)

    def dwconv(self, x_q: torch.Tensor) -> torch.Tensor:
        """The depthwise route: the accumulator and the epilogue in one
        operator, ``ops/dwconv.py::dwconv_int8`` (the kernel on the card,
        the f64 convolution and the epilogue's twin on the CPU), over its
        (C, 3, 4) weight (kept, :meth:`_cached`). The output is an NCHW
        view of NHWC memory, as :meth:`_epilogue`'s."""
        wt = self._cached("_dw_cache", lambda: dw_weight(self._weights()))
        out = dwconv_int8(x_q, wt, self.act_scale, self.w_scale, self.bias, self.out_scale,
                          self.stride, self.padding, self.out_qmin, self.out_qmax, self.chained)
        return out.permute(0, 3, 1, 2)

    def dequant_conv(self, x_q: torch.Tensor) -> torch.Tensor:
        """The first layer's route: f32 conv over the dequantized codes. On
        the card it is im2col and one f32 matmul with TF32 off for the call
        (FMA sums in a fixed order; no cuDNN algorithm choice)."""
        with span("int.gemm"):
            w_dq = self._weights().to(torch.float32) * self.w_scale[:, None, None, None]
            if x_q.device.type != "cuda":
                x_dq = x_q.to(torch.float32) * self.act_scale
                return TF.conv2d(x_dq, w_dq, None, self.stride, self.padding, self.dilation,
                                 self.groups)
            cols, (n, ho, wo) = self._im2col(x_q, self.act_scale)  # the dequantized patches
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
            x_q = _act_codes(x, s_x, self.act_zero_point, self.a_qmin, self.a_qmax,
                             self.symmetric)
        if self.depthwise:
            with span("int.dwconv"):
                return self.dwconv(x_q)
        if self.symmetric and self.w_symmetric:
            if self.f32_dequant:
                acc, w_scale = self.dequant_conv(x_q), None
            else:
                acc, w_scale = self.int_acc(x_q), self.w_scale
            with span("int.epilogue"):
                return self._epilogue(acc, w_scale)
        acc = self._zero_point_acc(x_q)
        with span("int.epilogue"):
            return self._finish(acc * (s_x * self.w_scale)[:, None, None])


class IntConvTranspose2d(_IntConvRoutes):
    """Integer transposed conv (``QuantConvTranspose2d`` frozen): int8 in,
    int8 weights with one layer-level scale (``w_scale`` and ``w_zp`` are
    scalars), exact accumulation, f32 epilogue; the zero points fold into
    the same correction terms as :class:`IntConv2d`'s. ``w_q`` has torch's
    transposed layout (in, out // groups, kh, kw); the GEMM runs the
    equivalent convolution (``w_shape`` is its (O, in // groups, kh,
    kw))."""

    transposed_kernels = ("w_q",)

    def __init__(self, w_q: torch.Tensor, w_scale, act_scale, act_zero_point, bias,
                 stride: Tuple[int, int], padding: Tuple[int, int],
                 output_padding: Tuple[int, int], dilation: Tuple[int, int], groups: int,
                 a_qmin: float, a_qmax: float):
        super().__init__()
        dev = w_q.device
        cin, og, kh, kw = w_q.shape
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", _scalar_buffer(w_scale, dev))
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("act_zero_point", _scalar_buffer(act_zero_point, dev))
        self.register_buffer("w_zp", torch.zeros((), device=dev))
        self.register_buffer("bias", None if bias is None else bias.clone())
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.output_padding = output_padding
        self.groups = groups
        self.a_qmin, self.a_qmax = a_qmin, a_qmax
        self.symmetric = a_qmin < 0
        self.w_symmetric = True
        self.w_shape = (og * groups, cin // groups, kh, kw)
        self._gemm_cache: Optional[Tuple[Tuple, torch.Tensor]] = None

    def _codes(self) -> torch.Tensor:
        return self.w_q

    def _weights(self) -> torch.Tensor:
        return self.w_q

    def _weights_hwio(self) -> torch.Tensor:
        """The equivalent convolution's (kh, kw, in // groups, O) kernel:
        spatially flipped, in and out swapped within each group."""
        cin, og, kh, kw = self.w_q.shape
        g = self.groups
        w = torch.flip(self.w_q.reshape(g, cin // g, og, kh, kw), dims=(3, 4))
        return w.permute(3, 4, 1, 0, 2).reshape(kh, kw, cin // g, g * og)

    def _ones_kernel(self, dev: torch.device) -> torch.Tensor:
        _, _, kh, kw = self.w_q.shape
        return torch.ones((self.w_q.shape[0], 1, kh, kw), dtype=torch.int8, device=dev)

    def _f64(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return TF.conv_transpose2d(x.to(torch.float64), w.to(torch.float64), None, self.stride,
                                   self.padding, self.output_padding, self.groups,
                                   self.dilation)

    def _gemm_geometry(self):
        return (1, 1), (0, 0), self.dilation

    def _gemm_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` dilated by the stride (zeros between its pixels), then
        edge-padded by ``d * (k - 1) - p`` (a crop where negative) and
        ``output_padding`` more on the high side."""
        n, c, h, w = x.shape
        (sh, sw), (ph, pw) = self.stride, self.padding
        (oph, opw), (dh, dw) = self.output_padding, self.dilation
        _, _, kh, kw = self.w_shape
        with span("int.im2col"):
            if (sh, sw) != (1, 1):
                xd = torch.zeros((n, c, (h - 1) * sh + 1, (w - 1) * sw + 1), dtype=x.dtype,
                                 device=x.device)
                xd[:, :, ::sh, ::sw] = x
                x = xd
            lo_h, lo_w = dh * (kh - 1) - ph, dw * (kw - 1) - pw
            return TF.pad(x, (lo_w, lo_w + opw, lo_h, lo_h + oph))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q = x if x.dtype == torch.int8 else _act_codes(
            x, self.act_scale, self.act_zero_point, self.a_qmin, self.a_qmax, self.symmetric)
        acc = self._zero_point_acc(x_q)
        with span("int.epilogue"):
            out = acc * (self.act_scale * self.w_scale)
            if self.bias is not None:
                out = out + self.bias[:, None, None]
            return out


class IntLinear(nn.Module):
    """Integer linear: w_q (in, out) int8, or nibble-packed (in/2, out)
    with symmetric W <= 4. Symmetric activations and weights run kernel
    K1 (``int8_linear``); otherwise, as the JAX package does, codes are
    stored ``q0 - 128`` and one plain integer matmul (``torch._int_mm`` on
    the card, f64 on the CPU) takes the rank-1 corrections."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, act_scale, act_zero_point,
                 bias, a_qmin: float, a_qmax: float):
        super().__init__()
        dev = w_q.device
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale.to(torch.float32).clone())
        self.register_buffer("act_scale", _scalar_buffer(act_scale, dev))
        self.register_buffer("act_zero_point", _scalar_buffer(act_zero_point, dev))
        self.register_buffer("w_zp", torch.zeros(w_q.shape[1], device=dev))
        self.register_buffer("bias", None if bias is None else bias.clone())
        self.a_qmin, self.a_qmax = a_qmin, a_qmax
        self.symmetric = a_qmin < 0
        self.w_symmetric = True
        self.w_packed = False
        self.w_shape = tuple(w_q.shape)

    def _weights(self) -> torch.Tensor:
        return unpack_int4(self.w_q) if self.w_packed else self.w_q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.symmetric and self.w_symmetric:
            with span("int.gemm"):
                return int8_linear(x, self._weights(), self.w_scale, self.act_scale,
                                   self.act_zero_point, self.bias, qmin=self.a_qmin,
                                   qmax=self.a_qmax)
        lead, k = x.shape[:-1], x.shape[-1]
        x_q = _act_codes(x.reshape(-1, k), self.act_scale, self.act_zero_point, self.a_qmin,
                         self.a_qmax, self.symmetric)
        sh_x = 0.0 if self.symmetric else 128.0 + self.act_zero_point
        w_q = self._weights()
        with span("int.gemm"):
            if x_q.device.type == "cuda":
                acc = _int_mm_exact(x_q, w_q.t())
            else:
                acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
        with span("int.epilogue"):
            acc = acc.to(torch.float32)
            colsum_w = torch.sum(w_q, dim=0, dtype=torch.int32).to(torch.float32)
            if self.w_symmetric:
                acc = acc + sh_x * colsum_w[None, :]
            else:
                sh_w = 128.0 + self.w_zp
                rowsum_x = torch.sum(x_q, dim=1, dtype=torch.int32).to(torch.float32)
                acc = (acc + sh_w[None, :] * rowsum_x[:, None] + sh_x * colsum_w[None, :]
                       + float(k) * sh_x * sh_w[None, :])
            out = acc * (self.act_scale * self.w_scale)[None, :]
            if self.bias is not None:
                out = out + self.bias
            return out.reshape(*lead, w_q.shape[1])


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
            with span("int.quantize"):
                x = torch.clamp(round_half_away(x.to(torch.float32) / s), self.a_qmin,
                                self.a_qmax).to(torch.int8)
        with span("int.pool"):
            y = F.max_pool2d(x, self.kernel_size, self.stride, self.padding)
        with span("int.epilogue"):
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
            with span("int.quantize"):
                x = torch.clamp(round_half_away(x.to(torch.float32) / s), self.a_qmin,
                                self.a_qmax).to(torch.int8)
        with span("int.pool"):
            xf = x.to(torch.float32) * s
            if self.adaptive_size is not None:
                return F.adaptive_avg_pool2d(xf, self.adaptive_size)
            return F.avg_pool2d(xf, self.kernel_size, self.stride, self.padding)


class _IntUnion(nn.Module):
    """Two inputs at one shared scale (``QuantAdd`` / ``QuantConcat``
    frozen): each arrives chained int8 (already at that scale) or f32
    (quantized here); the result dequantizes or requantizes to the
    consumer's scale."""

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
        with span("int.quantize"):
            return torch.clamp(round_half_away(x.to(torch.float32) / self.act_scale),
                               self.a_qmin, self.a_qmax).to(torch.int8)

    def _out(self, codes: torch.Tensor) -> torch.Tensor:
        """The union's codes (an epilogue span of the caller's) out at the
        consumer's scale, or dequantized."""
        if self.chained:
            q = round_half_away(codes.to(torch.float32) * (self.act_scale / self.out_scale))
            return torch.clamp(q, self.out_qmin, self.out_qmax).to(torch.int8)
        return codes.to(torch.float32) * self.act_scale


class IntAdd(_IntUnion):
    """Frozen ``QuantAdd``: the codes add in int32 with no rescale."""

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self._inq(a), self._inq(b)
        with span("int.epilogue"):
            return self._out(a.to(torch.int32) + b.to(torch.int32))


class IntConcat(_IntUnion):
    """Frozen ``QuantConcat``: the codes concatenate as a copy. ``axis`` is
    the JAX package's NHWC axis."""

    def __init__(self, axis: int, act_scale, a_qmin: float, a_qmax: float):
        super().__init__(act_scale, a_qmin, a_qmax)
        self.axis = axis

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dim = M.nchw_axis(self.axis, a.dim())
        a, b = self._inq(a), self._inq(b)
        with span("int.epilogue"):
            return self._out(torch.cat([a, b], dim=dim))


def _check_bits(wq: qat_iao.FakeQuantizer, aq: qat_iao.FakeQuantizer) -> None:
    if wq.bits > 8 or aq.bits > 8 or 1 in (wq.bits, aq.bits):
        raise NotImplementedError(
            "int engine freezes 2..8-bit weights/activations (int8 storage; sub-8-bit "
            "values ride int8 with narrower clip ranges)")


def _int8_activation(aq: qat_iao.FakeQuantizer) -> bool:
    """An activation-only layer freezes where its quantizer is symmetric at
    2..8 bits; otherwise it stays fake-quant, as in the JAX package."""
    return 1 < aq.bits <= 8 and aq.symmetric


@torch.no_grad()
def _freeze_conv(m: qat_iao.QuantConv2d) -> IntConv2d:
    wq, aq = m.weight_quantizer, m.activation_quantizer
    _check_bits(wq, aq)
    co = m.weight.shape[0]
    w_scale = torch.broadcast_to(wq.scale.reshape(-1), (co,))
    per_out = w_scale[:, None, None, None]
    if wq.symmetric:
        w_q = _quantize_weight_int8(m.weight, per_out, wq.qmin, wq.qmax)
    else:
        w_zp = torch.broadcast_to(wq.zero_point.reshape(-1), (co,))
        w_q = _shifted_weight_codes(m.weight, per_out, w_zp[:, None, None, None], wq.qmin,
                                    wq.qmax)
    out = IntConv2d(w_q, w_scale, aq.scale, m.bias, m.stride, m.padding, m.dilation,
                    m.groups, aq.qmin, aq.qmax, act_zero_point=aq.zero_point)
    if not wq.symmetric:
        # asymmetric codes are never packed
        out.w_symmetric = False
        out.w_zp.copy_(w_zp)
    elif wq.bits <= 4:
        _maybe_pack_w4(out, out._weights_hwio().reshape(-1, co))
    return out


@torch.no_grad()
def _freeze_convt(m: qat_iao.QuantConvTranspose2d) -> IntConvTranspose2d:
    wq, aq = m.weight_quantizer, m.activation_quantizer
    _check_bits(wq, aq)
    w_scale = wq.scale.reshape(())  # layer-level
    if wq.symmetric:
        w_q = _quantize_weight_int8(m.weight, w_scale, wq.qmin, wq.qmax)
    else:
        w_q = _shifted_weight_codes(m.weight, w_scale, wq.zero_point.reshape(()), wq.qmin,
                                    wq.qmax)
    out = IntConvTranspose2d(w_q, w_scale, aq.scale, aq.zero_point, m.bias, m.stride,
                             m.padding, m.output_padding, m.dilation, m.groups, aq.qmin,
                             aq.qmax)
    if not wq.symmetric:
        out.w_symmetric = False
        out.w_zp.copy_(wq.zero_point.reshape(()))
    return out


@torch.no_grad()
def _freeze_linear(m: qat_iao.QuantLinear) -> IntLinear:
    wq, aq = m.weight_quantizer, m.activation_quantizer
    _check_bits(wq, aq)
    w_scale = torch.broadcast_to(wq.scale.reshape(-1), (m.weight.shape[1],))
    if wq.symmetric:
        w_q = _quantize_weight_int8(m.weight, w_scale, wq.qmin, wq.qmax)
    else:
        w_zp = torch.broadcast_to(wq.zero_point.reshape(-1), (m.weight.shape[1],))
        w_q = _shifted_weight_codes(m.weight, w_scale, w_zp, wq.qmin, wq.qmax)
    out = IntLinear(w_q, w_scale, aq.scale, aq.zero_point, m.bias, aq.qmin, aq.qmax)
    if not wq.symmetric:
        out.w_symmetric = False
        out.w_zp.copy_(w_zp)
    elif wq.bits <= 4:
        _maybe_pack_w4(out, w_q)
    return out


def _maybe_pack_w4(mod, w_q_2d: torch.Tensor) -> None:
    """Store W <= 4 codes nibble-packed (two a byte) when the flat
    contraction dim is even."""
    if w_q_2d.shape[0] % 2 == 0:
        mod.w_q = pack_int4(w_q_2d)
        mod.w_packed = True


def _freeze_maxpool(m: qat_iao.QuantMaxPool2d):
    aq = m.activation_quantizer
    if not _int8_activation(aq):
        return m
    pool = IntMaxPool2d(m.kernel_size, m.stride, m.padding, aq.scale)
    pool.a_qmin, pool.a_qmax = aq.qmin, aq.qmax
    return pool


def _freeze_avgpool(m):
    aq = m.activation_quantizer
    if not _int8_activation(aq):
        return m
    if isinstance(m, qat_iao.QuantAdaptiveAvgPool2d):
        pool = IntAvgPool2d(None, None, None, aq.scale, m.output_size)
    else:
        pool = IntAvgPool2d(m.kernel_size, m.stride, m.padding, aq.scale)
    # clip at the a_bits range, not the int8 storage range
    pool.a_qmin, pool.a_qmax = aq.qmin, aq.qmax
    return pool


def _freeze_add(m: qat_iao.QuantAdd):
    aq = m.activation_quantizer
    return IntAdd(aq.scale, aq.qmin, aq.qmax) if _int8_activation(aq) else m


def _freeze_concat(m: qat_iao.QuantConcat):
    aq = m.activation_quantizer
    return IntConcat(m.axis, aq.scale, aq.qmin, aq.qmax) if _int8_activation(aq) else m


_FREEZERS = {
    qat_iao.QuantConv2d: _freeze_conv,
    qat_iao.QuantConvTranspose2d: _freeze_convt,
    qat_iao.QuantLinear: _freeze_linear,
    qat_iao.QuantMaxPool2d: _freeze_maxpool,
    qat_iao.QuantAvgPool2d: _freeze_avgpool,
    qat_iao.QuantAdaptiveAvgPool2d: _freeze_avgpool,
    qat_iao.QuantAdd: _freeze_add,
    qat_iao.QuantConcat: _freeze_concat,
}


def freeze_int(model: nn.Module, *, inplace: bool = False, chain_int8: bool = True,
               example_input: Optional[torch.Tensor] = None, device=None) -> nn.Module:
    """Convert a BN-fused, weight-pre-quantized inference model to the
    integer engine, on ``device`` (None = CUDA, which raises without a
    card). Symmetric and asymmetric (q_type 0 and 1) quantization at 2..8
    bits, symmetric W <= 4 nibble-packed; convs, transposed convs and
    linears freeze, and pools, adds and concats with a symmetric
    quantizer.

    With ``chain_int8`` the planner wires each emitter's requantizing
    epilogue to the next quantized layer's activation scale wherever only
    order-preserving modules (ReLU, ReLU6, MaxPool, Identity, Flatten) sit
    between them. Pass ``example_input`` (NHWC, batch may be 1) to trace
    the real dataflow, which branching graphs need: residual adds and
    concats then chain through :class:`IntAdd` and :class:`IntConcat`.
    Without it, a leaf-order fallback handles single-path graphs only.
    """
    dev = resolve_device(device)
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
# Flatten move memory only; ReLU6's clamp folds into the emitter's
# (:func:`_link`)
_PASSTHROUGH = (M.ReLU, M.ReLU6, M.MaxPool2d, M.Identity, M.Flatten)


def _is_emitter(m) -> bool:
    """Emitters can requantize their output to a receiver's int8 scale."""
    return (isinstance(m, IntConv2d) and m.symmetric) or isinstance(
        m, (IntMaxPool2d, IntAdd, IntConcat))


def _is_receiver(m) -> bool:
    """Receivers accept chained int8 quantized at their own act_scale."""
    return (isinstance(m, IntConv2d) and m.symmetric) or isinstance(
        m, (IntMaxPool2d, IntAvgPool2d, IntAdd, IntConcat))


@torch.no_grad()
def _link(emitter, receiver, between=()) -> None:
    """Chain ``emitter`` to ``receiver`` through the passthrough modules
    ``between``. A ReLU6 among them folds into the emitter's clamp: codes
    at the receiver's scale ``s`` clamp to ``[0, min(qmax, code(6))]``,
    ``code(6) = round_half_away(6 / s)`` as the requant computes it, which
    is the receiver's code of the clamped value (rounding and a positive
    scale keep the order), so the ReLU6 passes the codes on as they
    are."""
    emitter.chained = True
    emitter.out_scale.copy_(receiver.act_scale)
    emitter.out_qmin = receiver.a_qmin
    emitter.out_qmax = receiver.a_qmax
    relu6 = [m for m in between if isinstance(m, M.ReLU6)]
    if relu6:
        six = torch.full((), 6.0, device=receiver.act_scale.device)
        top = int(requant(six, receiver.act_scale, 0.0, receiver.a_qmax))
        emitter.out_qmin, emitter.out_qmax = max(receiver.a_qmin, 0.0), float(top)
        for m in relu6:
            m.code_max = top


def _plan_chains_leaf_order(model: nn.Module) -> None:
    """Chain along definition order. Only sound for single-path graphs (the
    last conv of a residual or concat branch is followed in leaf order by
    a sibling branch's module, not by its consumer), so it does nothing
    on a graph with an add or a concat."""
    if any(isinstance(m, (IntAdd, IntConcat, qat_iao.QuantAdd, qat_iao.QuantConcat))
           for m in model.modules()):
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
                _link(cur, ordered[j], ordered[i + 1:j])


def _plan_chains_dataflow(model: nn.Module, example_input: torch.Tensor) -> None:
    """Trace the real consumer graph and chain every emitter whose output
    feeds exactly one receiver (directly or through passthrough modules).
    Each producer into an IntAdd or IntConcat requantizes to its shared
    scale independently; an output that fans out to several consumers
    stays f32, and so does one that reaches its receiver through a ReLU6
    on other than a single path (the clamp folds into the emitter)."""
    from .dataflow import trace_dataflow

    node_types = [
        IntConv2d, IntConvTranspose2d, IntLinear, IntMaxPool2d, IntAvgPool2d, IntAdd,
        IntConcat, TernaryConv2d,
        # unfrozen fake-quant layers are opaque f32 nodes: chains never
        # jump across them
        qat_iao.QuantConv2d, qat_iao.QuantConvTranspose2d, qat_iao.QuantLinear,
        qat_iao.QuantReLU, qat_iao.QuantLeakyReLU, qat_iao.QuantSigmoid,
        qat_iao.QuantMaxPool2d, qat_iao.QuantAvgPool2d, qat_iao.QuantAdaptiveAvgPool2d,
        qat_iao.QuantAdd, qat_iao.QuantConcat,
    ] + list(_PASSTHROUGH)
    trace = trace_dataflow(model, example_input, node_types)
    consumers = trace.consumers()
    counts = trace.call_counts()

    def effective_receivers(m):
        """Non-passthrough consumers reached through passthrough modules,
        the passthrough modules passed, and whether the way is a single
        path; None when an output escapes the traced graph (then no
        chain)."""
        direct = consumers.get(id(m), [])
        if not direct:
            return None
        seen, out, between, stack = set(), [], [], list(direct)
        single = len(direct) == 1
        while stack:
            v = stack.pop()
            if id(v) in seen:
                continue
            seen.add(id(v))
            if isinstance(v, _PASSTHROUGH):
                nxt = consumers.get(id(v), [])
                if not nxt:
                    return None
                between.append(v)
                single = single and len(nxt) == 1
                stack.extend(nxt)
            else:
                out.append(v)
        return out, between, single

    uniq = {}
    for mod, _ in trace.calls:
        uniq.setdefault(id(mod), mod)
    for m in uniq.values():
        # a module called more than once would need one scale per call
        if not _is_emitter(m) or counts[id(m)] != 1:
            continue
        found = effective_receivers(m)
        if found is None:
            continue
        recv, between, single = found
        if len(recv) != 1 or recv[0] is m:
            continue
        if any(isinstance(v, M.ReLU6) for v in between) and not single:
            continue
        if _is_receiver(recv[0]):
            _link(m, recv[0], between)


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
        if x.dtype != torch.int8:
            with span("int.quantize"):
                x = x.to(torch.int8)
        acc = self.int_acc(x)
        with span("int.epilogue"):
            out = acc.to(torch.float32) * self.alpha[:, None, None]
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
