"""The code-storage lowering (``QuantConfig.act_codes``) of the port against
the JAX package's, layer by layer, on the CPU.

``act_codes="on"`` on the CPU runs the lowering with f32 codes in both
packages, so the port's IAO layers (``QuantConv2d`` at ``q_type`` 0 and 1
and grouped, ``QuantBNFuseConv2d`` with ``bn_fuse_calib`` both ways,
``QuantConvTranspose2d``, ``QuantLinear``) and DoReFa layers are held
against JAX's ``"on"`` on the same weights (``cnn_state_from_numpy``) and
numpy-seeded inputs: one training-mode forward and backward each, the
activation codes and qparams bit for bit, outputs within ``OUT_ATOL``,
input and parameter gradients within ``GRAD_RTOL`` x max|g|. ``"auto"``
stays the exact path on a CPU tensor, and 1, 16 and 32 bits and PTQ never
lower. JAX runs each layer's step eagerly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.nn import qat_dorefa as jdorefa
from micronet_tpu.nn import qat_iao as jiao
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.nn import qat_dorefa as tdorefa
from micronet_tpu_torch.nn import qat_iao as tiao
from micronet_tpu_torch.quant.config import QuantConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the same codes on both sides; the f32 conv or matmul sums in another
# order (outputs of size ~1 to 10)
OUT_ATOL = 2e-5
GRAD_RTOL = 1e-5  # x max|g| (input: of its gradient; parameters: of the step's)

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _to_port(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))


def _from_port(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _jax_step(layer, x, g):
    """One training-mode forward (observers update) and its VJP, eager:
    under ``jit`` XLA may rewrite a division by a constant as a multiply,
    and the qparams would move by an ulp from the JAX package's eager
    ones."""
    def loss(m, a):
        y = m(a)
        return jnp.sum(y * g), y

    (_, y), (gm, gx) = nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True)(layer, x)
    return y, gm, gx


def _grads_by_name(jgrads):
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in jgrads.flat_state()}


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _step_both(jl, tl, x, seed):
    """The same training step in both packages: output, input and
    parameter gradients (the caller compares the state it leaves)."""
    tl.zero_grad(set_to_none=True)
    tx = _to_port(x).requires_grad_()
    out = tl(tx)
    g = _np(seed, _from_port(out).shape)
    y, gm, gx = _jax_step(jl, jnp.asarray(x), jnp.asarray(g))
    jax_out = np.asarray(y)
    (out * _to_port(g)).sum().backward()
    _close(_from_port(out), jax_out, OUT_ATOL * max(1.0, np.abs(jax_out).max()), "output")
    gx = np.asarray(gx)
    _close(_from_port(tx.grad), gx, GRAD_RTOL * np.abs(gx).max(), "input gradient")
    want = cnn_state_from_numpy({tuple(k.split(".")): v
                                 for k, v in _grads_by_name(gm).items()}, tl)
    gmax = max(np.abs(v.numpy()).max() for v in want.values())
    for name, p in tl.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), GRAD_RTOL * gmax, f"gradient of {name}")


def _state_equal(tl, jl, keys):
    """The named quantizer state bit for bit."""
    ref = cnn_state_from_numpy(_flat(jl), tl)
    got = tl.state_dict()
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)


def _pair(jctor, tctor, jcfg, tcfg):
    jl = jctor(jcfg)
    tl = tctor(tcfg)
    tl.load_state_dict(cnn_state_from_numpy(_flat(jl), tl), strict=True)
    return jl, tl


_AQ = ("activation_quantizer.scale", "activation_quantizer.zero_point",
       "activation_quantizer.min_val", "activation_quantizer.max_val")
_WQ = ("weight_quantizer.scale", "weight_quantizer.zero_point")

# one input shape for every conv case, so JAX's eager op compiles are shared
X_CONV, X_LIN = (4, 8, 8, 8), (8, 32)
IAO_CASES = {
    "conv_q0_grouped": (
        dict(),
        lambda c: jiao.QuantConv2d(8, 8, 3, padding=1, groups=2, bias=True, cfg=c,
                                   rngs=nnx.Rngs(0)),
        lambda c: tiao.QuantConv2d(8, 8, 3, padding=1, groups=2, bias=True, cfg=c,
                                   device="cpu"),
        X_CONV, 3.0, _AQ + _WQ),
    "conv_q1": (
        dict(q_type=1),
        lambda c: jiao.QuantConv2d(8, 8, 3, padding=1, bias=True, cfg=c, rngs=nnx.Rngs(1)),
        lambda c: tiao.QuantConv2d(8, 8, 3, padding=1, bias=True, cfg=c, device="cpu"),
        X_CONV, 2.0, _AQ + _WQ),
    "bn_fuse": (
        dict(bn_fuse=True, bn_stats="off"),
        lambda c: jiao.QuantBNFuseConv2d(8, 8, 3, padding=1, bias=True, cfg=c,
                                         rngs=nnx.Rngs(2)),
        lambda c: tiao.QuantBNFuseConv2d(8, 8, 3, padding=1, bias=True, cfg=c, device="cpu"),
        X_CONV, 2.0, _AQ),
    "bn_fuse_calib_grouped": (
        dict(bn_fuse=True, bn_fuse_calib=True, bn_stats="off"),
        lambda c: jiao.QuantBNFuseConv2d(8, 8, 3, padding=1, groups=2, cfg=c,
                                         rngs=nnx.Rngs(3)),
        lambda c: tiao.QuantBNFuseConv2d(8, 8, 3, padding=1, groups=2, cfg=c, device="cpu"),
        X_CONV, 2.0, _AQ),
    "bn_fuse_q1": (
        dict(bn_fuse=True, q_type=1, bn_stats="off"),
        lambda c: jiao.QuantBNFuseConv2d(8, 8, 3, padding=1, cfg=c, rngs=nnx.Rngs(4)),
        lambda c: tiao.QuantBNFuseConv2d(8, 8, 3, padding=1, cfg=c, device="cpu"),
        X_CONV, 2.0, _AQ),
    "conv_transpose": (
        dict(),
        lambda c: jiao.QuantConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1,
                                            cfg=c, rngs=nnx.Rngs(5)),
        lambda c: tiao.QuantConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1,
                                            cfg=c, device="cpu"),
        X_CONV, 2.0, _AQ + _WQ),
    "conv_transpose_q1": (
        dict(q_type=1),
        lambda c: jiao.QuantConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1,
                                            cfg=c, rngs=nnx.Rngs(6)),
        lambda c: tiao.QuantConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1,
                                            cfg=c, device="cpu"),
        X_CONV, 2.0, _AQ + _WQ),
    "linear_q0": (
        dict(),
        lambda c: jiao.QuantLinear(32, 10, cfg=c, rngs=nnx.Rngs(7)),
        lambda c: tiao.QuantLinear(32, 10, cfg=c, device="cpu"),
        X_LIN, 4.0, _AQ + _WQ),
    "linear_q1_a4": (
        dict(q_type=1, a_bits=4, w_bits=4),
        lambda c: jiao.QuantLinear(32, 10, cfg=c, rngs=nnx.Rngs(8)),
        lambda c: tiao.QuantLinear(32, 10, cfg=c, device="cpu"),
        X_LIN, 4.0, _AQ + _WQ),
}


@pytest.mark.parametrize("case", list(IAO_CASES))
def test_iao_layer_codes_on_matches_jax(case):
    kw, jctor, tctor, shape, scale, keys = IAO_CASES[case]
    jl, tl = _pair(jctor, tctor, JQuantConfig(act_codes="on", **kw),
                   QuantConfig(act_codes="on", **kw))
    assert tiao._act_codes_enabled(tl.cfg, CPU) and jl.act_codes
    seed = 100 + list(IAO_CASES).index(case)
    # a training step seeds the observers
    _step_both(jl, tl, _np(seed, shape, scale), seed + 1)
    _state_equal(tl, jl, keys)
    # the codes of the next input, and the quantizer state they leave (the EMA)
    x = _np(seed + 50, shape, scale)
    c_j, s_j, zp_j = jl.activation_quantizer.codes(jnp.asarray(x))
    c_t, s_t, zp_t = tl.activation_quantizer.codes(_to_port(x))
    np.testing.assert_array_equal(_from_port(c_t), np.asarray(c_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(zp_t.numpy(), np.asarray(zp_j))
    _state_equal(tl, jl, _AQ)
    # eval mode: the frozen qparams through the codes
    jl.set_attributes(training=False, raise_if_not_found=False)
    tl.eval()
    x = _np(seed + 60, shape, scale)
    with torch.no_grad():
        out = _from_port(tl(_to_port(x)))
    want = np.asarray(jl(jnp.asarray(x)))
    _close(out, want, OUT_ATOL * max(1.0, np.abs(want).max()), "eval output")


DOREFA_CASES = {
    "conv": (lambda c: jdorefa.QuantConv2d(8, 8, 3, padding=1, cfg=c, rngs=nnx.Rngs(0)),
             lambda c: tdorefa.QuantConv2d(8, 8, 3, padding=1, cfg=c, device="cpu"), X_CONV),
    "conv_transpose": (
        lambda c: jdorefa.QuantConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1,
                                               cfg=c, rngs=nnx.Rngs(1)),
        lambda c: tdorefa.QuantConvTranspose2d(8, 8, 3, stride=2, padding=1, output_padding=1,
                                               cfg=c, device="cpu"),
        X_CONV),
    "linear": (lambda c: jdorefa.QuantLinear(32, 10, cfg=c, rngs=nnx.Rngs(2)),
               lambda c: tdorefa.QuantLinear(32, 10, cfg=c, device="cpu"), X_LIN),
}


@pytest.mark.parametrize("case", list(DOREFA_CASES))
@pytest.mark.parametrize("bits", [8, 4])
def test_dorefa_layer_codes_on_matches_jax(case, bits):
    jctor, tctor, shape = DOREFA_CASES[case]
    kw = dict(a_bits=bits, w_bits=bits)
    jl, tl = _pair(jctor, tctor, JQuantConfig(act_codes="on", **kw),
                   QuantConfig(act_codes="on", **kw))
    x = _np(200 + bits, shape, 30.0)  # x * 0.1 spans the clip's [0, 1] and past it
    _step_both(jl, tl, x, 300 + bits)
    from micronet_tpu.quant import dorefa as jq
    from micronet_tpu_torch.quant import dorefa as tq

    c_j, s_j = jq.activation_codes(jnp.asarray(x), bits)
    c_t, s_t = tq.activation_codes(_to_port(x), bits)
    np.testing.assert_array_equal(_from_port(c_t), np.asarray(c_j))
    assert s_t == s_j


def _exact_and(cfg_kw, mode):
    """A QuantConv2d at ``act_codes=mode`` and the same at "off"."""
    gen = torch.Generator().manual_seed(0)
    a = tiao.QuantConv2d(8, 8, 3, padding=1, cfg=QuantConfig(act_codes=mode, **cfg_kw),
                         device="cpu", generator=gen)
    b = tiao.QuantConv2d(8, 8, 3, padding=1, cfg=QuantConfig(act_codes="off", **cfg_kw),
                         device="cpu")
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.parametrize("mode,cfg_kw", [
    ("auto", dict()), ("auto", dict(q_type=1)), ("on", dict(a_bits=16)),
    ("on", dict(a_bits=32)), ("on", dict(ptq=True)), ("on", dict(ptq=True, ptq_observer="kl")),
])
def test_auto_on_cpu_and_ineligible_configs_run_the_exact_path(mode, cfg_kw):
    a, b = _exact_and(cfg_kw, mode)
    x = torch.from_numpy(_np(7, (2, 8, 6, 6), 2.0))
    for _ in range(2):
        torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
    for ka, kb in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(ka, kb)


def test_resolvers_follow_jax_on_the_cpu_and_lower_on_cuda():
    """The port's resolvers on a CPU tensor against JAX's on its CPU
    backend, over a grid of configs; on a CUDA device ``"auto"`` lowers
    (a device object needs no card)."""
    grid = [dict(a_bits=a, act_codes=m, ptq=p, q_level=ql, q_type=qt, bn_stats=bs)
            for a in (1, 4, 8, 16, 32) for m in ("auto", "on", "off") for p in (False, True)
            for ql in (0, 1) for qt in (0, 1) for bs in ("auto", "on", "off", "acc")]
    for kw in grid:
        tc, jc = QuantConfig(**kw), JQuantConfig(**kw)
        assert tiao._act_codes_enabled(tc, CPU) == jiao._act_codes_enabled(jc), kw
        assert tiao._acc_stats_enabled(tc, CPU) == jiao._acc_stats_enabled(jc), kw
        assert tiao._bf16_stats_enabled(tc, CPU) == jiao._bf16_stats_enabled(jc), kw
        on_card = kw["a_bits"] not in (1, 16, 32) and not kw["ptq"] and kw["act_codes"] != "off"
        assert tiao._act_codes_enabled(tc, CUDA) == on_card, kw
        acc = kw["q_level"] == 0 and kw["q_type"] == 0 and kw["bn_stats"] in ("auto", "acc")
        assert tiao._acc_stats_enabled(tc, CUDA) == acc, kw
        bf16 = kw["bn_stats"] == "on" or (kw["bn_stats"] == "auto" and not acc)
        assert tiao._bf16_stats_enabled(tc, CUDA) == bf16, kw
    assert tiao._codes_dtype(CPU) == torch.float32
    assert tiao._codes_dtype(CUDA) == torch.bfloat16


def test_codes_equal_the_fake_quant_exactly():
    """``(codes + zp) * s`` is the fake-quant output bit for bit, and the
    codes' gradient is the fake-quant's over ``s``."""
    for sym in (True, False):
        fq = tiao.FakeQuantizer(8, symmetric=sym, device="cpu")
        x = torch.from_numpy(_np(9, (64,), 3.0)).requires_grad_()
        y = fq(x)
        fq.eval()
        c, s, zp = fq.codes(x)
        torch.testing.assert_close((c + zp) * s, fq(x.detach()), rtol=0, atol=0)
        gy, = torch.autograd.grad(y.sum(), x)
        gc, = torch.autograd.grad(c.sum(), x)
        torch.testing.assert_close(gc * s, gy, rtol=0, atol=1e-7)
