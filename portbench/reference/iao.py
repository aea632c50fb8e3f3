"""Plain PyTorch reference of IAO quantization-aware networks: the
integer-arithmetic-only scheme of Jacob et al. (arXiv:1712.05877) as
micronet's ``wqaq/iao`` recipe applies it, run over an op list of
:mod:`.arch`.

Nothing here imports the program under test; it is written from the
recipe's equations:

- symmetric quantizers: weights in ``[-(2^(b-1) - 1), 2^(b-1) - 1]``,
  activations in ``[-2^(b-1), 2^(b-1) - 1]``; ``scale = max(|min|, |max|)
  / ((qmax - qmin) / 2)``, floored at the f32 epsilon; a value becomes
  ``clamp(round_half_away(x / scale), qmin, qmax) * scale``. The gradient
  passes straight through inside the observed range (a clip's gradient:
  half on its bounds, none outside);
- activation ranges: per tensor, an EMA of each batch's min and max
  (momentum 0.1, the first batch taken as it is); weight ranges: per
  output channel (per output column of a linear), the running min and
  max over every batch seen;
- conv + BN folded in training, with the batch's mean and unbiased
  variance and EMA running statistics (the first batch seeds them):
  ``stats="exact"`` takes the statistics of the float conv and folds
  them into the weight; ``stats="acc"`` folds the running statistics
  from before the update into the weight, takes the batch statistics of
  that one quantized conv's accumulator divided back by the fold, and
  rescales the accumulator to the batch fold;
- after calibration or training (``train=False``), BN folds into the
  conv with the running statistics, and the folded weight is quantized
  with its quantizer's range;
- a residual add quantizes both addends with one scale, the union of two
  EMA observers' ranges; pools quantize their input.

Everything runs in ``dtype`` (float32 for the reference; a lower one for
the control), NCHW inside, NHWC images in. ``codes_dtype`` (bfloat16)
is the code-storage lowering of the quantized convs: activation codes
and quantized weights as bfloat16 values, products summed in ``dtype``,
the conv's output rounded to bfloat16, then scaled. ``epilogue_dtype``
(a control) rounds the output of every conv, residual add and the fc to
that type once calibration is over, as an engine whose requant epilogue
ran in it would.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as TF

F32_EPS = 1.1920928955078125e-07
BN_EPS = 1e-5
MOMENTUM = 0.1


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (taken in f64, rounded once)."""
    return torch.sqrt(x.double()).to(x.dtype)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def qrange(bits: int, weight: bool):
    top = 2 ** (bits - 1) - 1
    return (-float(top), float(top)) if weight else (-float(top + 1), float(top))


class Quantizer:
    """One symmetric fake quantizer and its observer state."""

    def __init__(self, bits: int, weight: bool, dims=None, ema: bool = True):
        self.qmin, self.qmax = qrange(bits, weight)
        self.dims = dims  # reduced dims (None: the whole tensor)
        self.ema = ema
        self.min = self.max = None

    def observe(self, x: torch.Tensor) -> None:
        x = x.detach()
        if self.dims is None:
            lo, hi = x.min().reshape(1), x.max().reshape(1)
        else:
            lo, hi = torch.amin(x, self.dims, keepdim=True), torch.amax(x, self.dims, keepdim=True)
        if self.min is None:
            self.min, self.max = lo, hi
        elif self.ema:
            self.min = (1 - MOMENTUM) * self.min + MOMENTUM * lo
            self.max = (1 - MOMENTUM) * self.max + MOMENTUM * hi
        else:
            self.min, self.max = torch.minimum(self.min, lo), torch.maximum(self.max, hi)

    def scale(self) -> torch.Tensor:
        span = torch.maximum(self.min.abs(), self.max.abs())
        half = torch.tensor((self.qmax - self.qmin) / 2, dtype=span.dtype, device=span.device)
        return torch.clamp_min(span / half, F32_EPS)

    def codes(self, x: torch.Tensor):
        """``(codes, scale)``: the integer codes, carrying the clip's
        gradient with respect to ``x / scale``, and the scale."""
        s = self.scale()
        v = x / s
        bound = torch.maximum((self.min / s).abs(), (self.max / s).abs())
        base = torch.minimum(torch.maximum(v, -bound), bound)
        q = torch.clamp(round_half_away(v.detach()), self.qmin, self.qmax)
        return base - base.detach() + q, s

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c, s = self.codes(x)
        return c * s


def shuffle_channels(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Output channel ``k * groups + r`` is input channel ``r * (C / groups) + k``."""
    c = x.shape[1]
    per = c // groups
    order = [r * per + k for k in range(per) for r in range(groups)]
    return x[:, order]


class IaoNet:
    """An IAO network over ``ops`` with float ``weights`` (the keys of
    :func:`.arch.param_shapes`). ``params`` are the trainable leaves, keyed
    as the float model's (a conv's BN gamma and beta under the BN's keys)."""

    def __init__(self, ops: List[dict], weights: Dict[str, torch.Tensor], a_bits: int,
                 w_bits: int, stats: str = "exact", dtype=torch.float32,
                 codes_dtype: Optional[torch.dtype] = None,
                 epilogue_dtype: Optional[torch.dtype] = None):
        if stats not in ("exact", "acc"):
            raise ValueError(f"stats {stats!r}")
        self.ops, self.stats, self.dtype = ops, stats, dtype
        self.codes_dtype, self.epilogue_dtype = codes_dtype, epilogue_dtype
        self.a_bits, self.w_bits = a_bits, w_bits
        self.params: Dict[str, torch.Tensor] = {}
        self.running: Dict[str, List[Optional[torch.Tensor]]] = {}
        self.quant: Dict[str, Quantizer] = {}
        for k, v in weights.items():
            if k.endswith(("running_mean", "running_var")):
                continue
            self.params[k] = v.detach().to(dtype).clone().requires_grad_(True)
        self._walk(self._init_op)

    # -- construction -----------------------------------------------------

    def _walk(self, fn):
        for op in self.ops:
            fn(op)
            if op["kind"] == "block":
                for c in op["residual"] + ([op["shortcut"]] if op["shortcut"] else []):
                    fn(c)

    def _aq(self, key: str) -> Quantizer:
        return self.quant.setdefault(key, Quantizer(self.a_bits, False))

    def _init_op(self, op: dict) -> None:
        if op["kind"] == "conv_bn":
            self.running[op["bn"]] = [None, None]
            self.quant[op["conv"] + ".w"] = Quantizer(self.w_bits, True, (1, 2, 3), ema=False)
        elif op["kind"] == "fc":
            self.quant[op["key"] + ".w"] = Quantizer(self.w_bits, True, (0,), ema=False)

    # -- layers -----------------------------------------------------------

    def _epilogue(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        if train or self.epilogue_dtype is None:
            return y
        return y.to(self.epilogue_dtype).to(self.dtype)

    def _conv(self, x, w, c):
        return TF.conv2d(x, w, None, c["stride"], c["pad"], 1, c["groups"])

    def _qconv(self, aq: Quantizer, x, qw, c):
        """The quantized conv. With ``codes_dtype`` it reads the activation
        codes and the quantized weight as that type's values (and their
        gradients come back in it), sums in ``dtype`` and rounds its output
        to that type before the scale multiplies it."""
        if self.codes_dtype is None:
            return self._conv(aq(x), qw, c)
        low = self.codes_dtype
        codes, s = aq.codes(x)
        y = self._conv(codes.to(low).to(self.dtype), qw.to(low).to(self.dtype), c)
        return y.to(low).to(self.dtype) * s

    def _moments(self, y):
        n = y.shape[0] * y.shape[2] * y.shape[3]
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False) * (n / max(n - 1, 1))
        return mean, var

    def _update_running(self, key, mean, var):
        run = self.running[key]
        mean, var = mean.detach(), var.detach()
        if run[0] is None:
            run[0], run[1] = mean, var
        else:
            run[0] = (1 - MOMENTUM) * run[0] + MOMENTUM * mean
            run[1] = (1 - MOMENTUM) * run[1] + MOMENTUM * var

    def _conv_bn(self, c: dict, x: torch.Tensor, train: bool) -> torch.Tensor:
        if c["shuffle"]:
            x = shuffle_channels(x, c["shuffle"])
        w = self.params[f"{c['conv']}.weight"]
        b = self.params.get(f"{c['conv']}.bias")
        gamma, beta = self.params[f"{c['bn']}.weight"], self.params[f"{c['bn']}.bias"]
        aq, wq = self._aq(c["conv"] + ".a"), self.quant[c["conv"] + ".w"]
        per_out = (slice(None), None, None, None)
        chan = (slice(None), None, None)
        bias = b if b is not None else torch.zeros_like(beta)
        if not train:
            mean, var = self.running[c["bn"]]
            inv = gamma / sqrt(var + BN_EPS)
            y = self._qconv(aq, x, wq(w * inv[per_out]), c) + (beta + (bias - mean) * inv)[chan]
        elif self.stats == "exact":
            out_f = self._conv(x, w, c) + bias[chan]
            mean, var = self._moments(out_f)
            self._update_running(c["bn"], mean, var)
            inv = gamma / sqrt(var + BN_EPS)
            wf = w * inv[per_out]
            wq.observe(wf)
            aq.observe(x)
            y = self._qconv(aq, x, wq(wf), c) + (beta + (bias - mean) * inv)[chan]
        else:
            run_var = self.running[c["bn"]][1]
            if run_var is None:
                run_var = torch.ones_like(beta.detach())
            inv_run = gamma / sqrt(run_var + BN_EPS)
            safe = torch.where(inv_run.abs() < 1e-12, torch.full_like(inv_run, 1e-12), inv_run)
            wf = w * inv_run[per_out]
            wq.observe(wf)
            aq.observe(x)
            acc = self._qconv(aq, x, wq(wf), c)
            acc_mean, acc_var = self._moments(acc)
            mean = acc_mean / safe + bias
            var = acc_var / torch.square(safe)
            self._update_running(c["bn"], mean, var)
            fused_bias = beta + (bias - mean) * (gamma / sqrt(var + BN_EPS))
            corr = sqrt(run_var + BN_EPS) / sqrt(var + BN_EPS)
            y = acc * corr[chan] + fused_bias[chan]
        y = self._epilogue(y, train)
        return torch.relu(y) if c["relu"] else y

    def _quant_in(self, key: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        q = self._aq(key)
        if train:
            q.observe(x)
        return q(x)

    def _block(self, op: dict, x: torch.Tensor, train: bool) -> torch.Tensor:
        r = x
        for c in op["residual"]:
            r = self._conv_bn(c, r, train)
        s = self._conv_bn(op["shortcut"], x, train) if op["shortcut"] else x
        qa, qb = self._aq(op["key"] + ".res"), self._aq(op["key"] + ".short")
        union = self._aq(op["key"] + ".add")
        if train:
            qa.observe(r)
            qb.observe(s)
            union.min = torch.minimum(qa.min, qb.min)
            union.max = torch.maximum(qa.max, qb.max)
        return torch.relu(self._epilogue(union(r) + union(s), train))

    def forward(self, images_nhwc: torch.Tensor, train: bool) -> torch.Tensor:
        """Logits of NHWC ``images``; ``train`` observes and uses batch
        statistics (calibration and training), else the stored state."""
        x = images_nhwc.to(self.dtype).permute(0, 3, 1, 2)
        for i, op in enumerate(self.ops):
            kind = op["kind"]
            if kind == "conv_bn":
                x = self._conv_bn(op, x, train)
            elif kind == "maxpool":
                x = TF.max_pool2d(self._quant_in(f"pool{i}", x, train), op["k"], op["stride"])
            elif kind == "avgpool":
                x = TF.avg_pool2d(self._quant_in(f"pool{i}", x, train), op["k"], op["stride"])
            elif kind == "block":
                x = self._block(op, x, train)
            elif kind == "gap":
                x = self._quant_in(f"pool{i}", x, train).mean(dim=(2, 3))
            elif kind == "fc":
                w, b = self.params[f"{op['key']}.weight"], self.params[f"{op['key']}.bias"]
                wq = self.quant[op["key"] + ".w"]
                if train:
                    wq.observe(w)
                x = self._epilogue(self._quant_in(op["key"] + ".a", x, train) @ wq(w) + b, train)
            else:
                raise ValueError(f"unknown op {kind!r}")
        return x.reshape(x.shape[0], -1)

    __call__ = forward
