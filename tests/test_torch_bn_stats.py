"""The batch-statistics lowerings of ``QuantBNFuseConv2d``
(``QuantConfig.bn_stats``) of the port against the JAX package's, on the
CPU.

``"on"`` runs the statistics conv with bf16 operands and a bf16 output in
both packages (JAX casts on the CPU too); ``"acc"`` takes the statistics
from the quantized conv's accumulator divided back by the running fold.
Each is held against JAX's on the same weights and numpy-seeded inputs:
two training forwards (the first seeds the running statistics, the
second runs the EMA), the first with its VJP, then the running
statistics and an eval forward; the tolerances are below. Then acc's
documented deviation (its statistics are those of the quantized conv's
accumulator, not of the float conv), the fallback to the statistics conv
where acc does not apply (``q_level=1``, ``q_type=1``) and a finite step
with gamma at 0. JAX runs eagerly. A loss trajectory of a narrow NIN:
``test_torch_bn_stats_trajectory.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.nn import qat_iao as jiao
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.nn import functional as F
from micronet_tpu_torch.nn import qat_iao as tiao
from micronet_tpu_torch.quant.config import QuantConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# "acc" and "on" with f32 operands elsewhere: the same values summed in
# another order (outputs of size ~1); the batch statistics fold into the
# weights before their fake-quant, so a weight code at a .5 edge may move
ACC_OUT_ATOL = 1e-4  # x max(1, max|out|)
# "on": each package rounds its f32 conv sums to bf16; where the sums
# differ in the last f32 bit a value may round to the neighbouring bf16
# (2^-8 relative), which moves a mean or variance by far less than that
BF16_OUT_ATOL = 1e-4  # x max(1, max|out|)
STAT_RTOL = 1e-5  # running statistics, x max(1, max|value|)
GRAD_RTOL = 1e-5  # x max|g| (input: of its gradient; parameters: of the step's)
# "on": the statistics conv's backward runs in bf16 too, so a gradient term
# may round to the neighbouring bf16 value: one bf16 step of max|g|
BF16_GRAD_RTOL = 2.0 ** -8

X = (8, 8, 8, 8)


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _to_port(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _from_port(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _pair(kw, bias=True, groups=1, seed=0):
    jl = jiao.QuantBNFuseConv2d(8, 8, 3, padding=1, groups=groups, bias=bias,
                                cfg=JQuantConfig(bn_fuse=True, **kw), rngs=nnx.Rngs(seed))
    tl = tiao.QuantBNFuseConv2d(8, 8, 3, padding=1, groups=groups, bias=bias,
                                cfg=QuantConfig(bn_fuse=True, **kw), device="cpu")
    tl.load_state_dict(cnn_state_from_numpy(_flat(jl)), strict=True)
    return jl, tl


def _jax_step(layer, x, g):
    def loss(m, a):
        y = m(a)
        return jnp.sum(y * g), y

    (_, y), (gm, gx) = nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True)(layer, x)
    return np.asarray(y), gm, np.asarray(gx)


def _compare_step(jl, tl, x, seed, out_atol, grad_rtol=GRAD_RTOL):
    tl.zero_grad(set_to_none=True)
    tx = _to_port(x).requires_grad_()
    out = tl(tx)
    g = _np(seed, X)
    y, gm, gx = _jax_step(jl, jnp.asarray(x), jnp.asarray(g))
    (out * _to_port(g)).sum().backward()
    _close(_from_port(out), y, out_atol * max(1.0, np.abs(y).max()), "output")
    _close(_from_port(tx.grad), gx, grad_rtol * np.abs(gx).max(), "input gradient")
    want = cnn_state_from_numpy({path: np.asarray(v[...]) for path, v in gm.flat_state()})
    gmax = max(np.abs(v.numpy()).max() for v in want.values())
    for name, p in tl.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), grad_rtol * gmax, f"gradient of {name}")


def _running_close(tl, jl):
    for name in ("running_mean", "running_var"):
        want = np.asarray(getattr(jl, name)[...])
        _close(getattr(tl, name).numpy(), want, STAT_RTOL * max(1.0, np.abs(want).max()), name)
    assert bool(tl.bn_initialized) and bool(jl.bn_initialized[...])


def _layer_vs_jax(kw, out_atol, bias=True, groups=1, seed=0, grad_rtol=GRAD_RTOL):
    jl, tl = _pair(kw, bias, groups, seed)
    _compare_step(jl, tl, _np(seed + 10, X, 2.0), seed + 11, out_atol, grad_rtol)
    _running_close(tl, jl)
    x = _np(seed + 12, X, 1.5)
    with torch.no_grad():
        out = _from_port(tl(_to_port(x)))
    want = np.asarray(jl(jnp.asarray(x)))
    _close(out, want, out_atol * max(1.0, np.abs(want).max()), "second training output")
    _running_close(tl, jl)
    jl.set_attributes(training=False, raise_if_not_found=False)
    tl.eval()
    x = _np(seed + 13, X)
    with torch.no_grad():
        out = _from_port(tl(_to_port(x)))
    want = np.asarray(jl(jnp.asarray(x)))
    _close(out, want, out_atol * max(1.0, np.abs(want).max()), "eval output")
    return jl, tl


@pytest.mark.parametrize("calib,bias", [(False, True), (True, False)])
def test_bf16_stats_on_matches_jax(calib, bias):
    _, tl = _layer_vs_jax(dict(bn_stats="on", act_codes="off", bn_fuse_calib=calib),
                          BF16_OUT_ATOL, bias=bias, seed=1 + calib, grad_rtol=BF16_GRAD_RTOL)
    assert tiao._bf16_stats_enabled(tl.cfg, torch.device("cpu"))


@pytest.mark.parametrize("calib,bias,groups", [(False, True, 1), (True, False, 2)])
def test_acc_stats_matches_jax(calib, bias, groups):
    _, tl = _layer_vs_jax(dict(bn_stats="acc", bn_fuse_calib=calib), ACC_OUT_ATOL, bias=bias,
                          groups=groups, seed=3 + calib)
    assert tiao._acc_stats_enabled(tl.cfg, torch.device("cpu"))


def test_acc_stats_and_codes_on_matches_jax():
    """Both lowerings together, as ``"auto"`` runs them on the card (f32
    codes on the CPU)."""
    _layer_vs_jax(dict(bn_stats="acc", act_codes="on"), ACC_OUT_ATOL, seed=5)


def _seeded(kw, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tiao.QuantBNFuseConv2d(8, 8, 3, padding=1, bias=True,
                                  cfg=QuantConfig(bn_fuse=True, **kw), device="cpu",
                                  generator=gen)


def test_acc_stats_are_the_quantized_accumulators():
    """acc's documented deviation: the running statistics after a step are
    the EMA of the statistics of ``conv(q(x), q(w * inv_run))`` divided
    back by ``inv_run`` (computed here from a copy of the layer's
    quantizers), and differ from the float statistics conv's by the
    quantization alone."""
    acc, ref = _seeded(dict(bn_stats="acc")), _seeded(dict(bn_stats="off"))
    ref.load_state_dict(acc.state_dict())
    for i in range(2):  # the first batch seeds the statistics, the second runs the EMA
        x = torch.from_numpy(_np(20 + i, (8, 8, 6, 6), 2.0))
        probe = copy.deepcopy(acc)
        with torch.no_grad():
            inv_run = probe.gamma / F.sqrt(probe.running_var + probe.eps)
            qx = probe.activation_quantizer(x)
            qw = probe.weight_quantizer(probe.weight * inv_run[:, None, None, None])
            a = F.conv2d(qx, qw, None, 1, 1)
            n = a.shape[0] * a.shape[2] * a.shape[3]
            mean = a.mean((0, 2, 3)) / inv_run + probe.bias
            var = a.var((0, 2, 3), unbiased=False) * (n / (n - 1)) / inv_run ** 2
            if i:
                mean = 0.9 * probe.running_mean + 0.1 * mean
                var = 0.9 * probe.running_var + 0.1 * var
            acc(x)
            ref(x)
        torch.testing.assert_close(acc.running_mean, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(acc.running_var, var, rtol=1e-5, atol=1e-6)
        # the float conv's statistics differ by the quantization of x and w only
        dev = (acc.running_var - ref.running_var).abs().max() / ref.running_var.abs().max()
        assert 0 < float(dev) < 0.05


@pytest.mark.parametrize("kw", [dict(q_level=1), dict(q_type=1)])
def test_acc_falls_back_to_the_stats_conv(kw):
    """Where ``q(w * s) == q(w) * s`` does not hold, ``"acc"`` runs the
    exact statistics conv: bit for bit the ``"off"`` layer's step, and
    JAX's fallback within ``ACC_OUT_ATOL``."""
    acc, off = _seeded(dict(bn_stats="acc", **kw)), _seeded(dict(bn_stats="off", **kw))
    off.load_state_dict(acc.state_dict())
    assert not tiao._acc_stats_enabled(acc.cfg, torch.device("cpu"))
    for i in range(2):
        x = torch.from_numpy(_np(30 + i, (4, 8, 6, 6), 2.0))
        torch.testing.assert_close(acc(x), off(x), rtol=0, atol=0)
    for a, b in zip(acc.state_dict().values(), off.state_dict().values()):
        assert torch.equal(a, b)
    _layer_vs_jax(dict(bn_stats="acc", **kw), ACC_OUT_ATOL, seed=6)


def test_acc_stats_finite_with_gamma_at_zero():
    """gamma trained to 0 (or near it): the divide-back floors |inv_run| at
    1e-12, so the step stays finite, in value and gradient, and equal to
    JAX's."""
    jl, tl = _pair(dict(bn_stats="acc"), seed=7)
    gamma = np.asarray(jl.gamma[...]).copy()
    gamma[:3] = [0.0, 1e-14, -1e-13]
    jl.gamma[...] = jnp.asarray(gamma)
    tl.load_state_dict(cnn_state_from_numpy(_flat(jl)), strict=True)
    x = _np(40, X, 2.0)
    _compare_step(jl, tl, x, 41, ACC_OUT_ATOL)
    out = tl(_to_port(x))
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(tl.running_var).all()
    assert all(torch.isfinite(p.grad).all() for p in tl.parameters())
