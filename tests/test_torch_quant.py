"""The port's quantization primitives and IAO layers against the JAX package.

The same numpy inputs go through both packages. Rounding, quantizers and
observers are elementwise or reductions over the same values, so they
agree bit for bit, on .5 code boundaries too. The conv and linear layers
differ only in the order of f32 sums inside the convolution or matmul,
and each comparison states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.nn import qat_iao as jqat
from micronet_tpu.quant import observers as jobs
from micronet_tpu.quant import quantizers as jq
from micronet_tpu.quant import rounding as jr
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.nn import qat_iao as tqat
from micronet_tpu_torch.quant import observers as tobs
from micronet_tpu_torch.quant import quantizers as tq
from micronet_tpu_torch.quant import rounding as tr
from micronet_tpu_torch.quant.config import QuantConfig


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _ties(seed, shape, lim=20):
    """Values j + 0.5: where half-away and half-even rounding differ."""
    x = np.random.default_rng(seed).integers(-lim, lim, shape).astype(np.float32) + 0.5
    return x


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------
# rounding
# --------------------------------------------------------------------------


def test_round_half_away_bit_exact_on_ties():
    x = np.concatenate([_ties(0, (64,)), _np(1, (64,), 5.0), [0.0, -0.5, 0.5, 2.5, -2.5]])
    x = x.astype(np.float32)
    out = tr.round_half_away(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jr.round_half_away(jnp.asarray(x))))
    assert out[-2] == 3.0 and out[-1] == -3.0  # torch.round would give 2, -2
    assert np.any(out != np.round(x))


def test_ste_round_value_and_identity_gradient():
    x = torch.from_numpy(np.concatenate([_ties(2, (16,)), _np(3, (16,), 4.0)])).requires_grad_()
    y = tr.ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jr.ste_round(jnp.asarray(x.detach().numpy()))))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_clip_ste_round_gradient_matches_jax_custom_vjp():
    """Gradient passes where lo <= x <= hi, the bounds themselves included."""
    lo, hi = np.float32(-3.0), np.float32(2.5)
    x = np.array([-4.0, -3.0, -2.9, -0.5, 0.0, 1.5, 2.5, 2.6, 7.0], np.float32)
    g = np.arange(1, x.size + 1, dtype=np.float32)
    yj, vjp = jax.vjp(lambda v: jr.clip_ste_round(v, lo, hi), jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tr.clip_ste_round(xt, torch.tensor(lo), torch.tensor(hi))
    yt.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(xt.grad.numpy() != 0, (x >= lo) & (x <= hi))


# --------------------------------------------------------------------------
# quantizers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("is_weight", [True, False])
def test_quant_range_matches_jax(bits, symmetric, is_weight):
    assert tq.quant_range(bits, symmetric, is_weight) == jq.quant_range(bits, symmetric, is_weight)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_qparams_and_fake_quant_bit_exact(symmetric, bits):
    """Per-channel stats (4 channels); a quarter of the values sit on .5
    boundaries of the codes under the scale the observer derives."""
    qmin, qmax = jq.quant_range(bits, symmetric, False)
    mn = np.array([-3.0, -0.7, 0.0, -12.0], np.float32).reshape(4, 1)
    mx = np.array([2.5, 0.9, 1.5, 3.0], np.float32).reshape(4, 1)
    sj, zj = (jq.symmetric_qparams if symmetric else jq.asymmetric_qparams)(
        jnp.asarray(mn), jnp.asarray(mx), qmin, qmax)
    st, zt = (tq.symmetric_qparams if symmetric else tq.asymmetric_qparams)(
        torch.from_numpy(mn), torch.from_numpy(mx), qmin, qmax)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    s = np.asarray(sj)
    x = _np(4, (4, 64), 2.0)
    ties = (_ties(5, (4, 64), int(qmax)) + np.asarray(zj)) * s
    x = np.where(np.random.default_rng(6).random((4, 64)) < 0.25, ties, x).astype(np.float32)
    args_j = (jnp.asarray(x), sj, zj, qmin, qmax, jnp.asarray(mn), jnp.asarray(mx), symmetric)
    args_t = (torch.from_numpy(x), st, zt, qmin, qmax, torch.from_numpy(mn),
              torch.from_numpy(mx), symmetric)
    np.testing.assert_array_equal(tq.fake_quant_codes(*args_t).numpy(),
                                  np.asarray(jq.fake_quant_codes(*args_j)))
    np.testing.assert_array_equal(tq.fake_quant(*args_t).numpy(),
                                  np.asarray(jq.fake_quant(*args_j)))
    # int32 storage: the unsigned 8-bit range does not fit int8
    qi_t = tq.quantize_int(torch.from_numpy(x), st, zt, qmin, qmax, torch.int32)
    qi_j = jq.quantize_int(jnp.asarray(x), sj, zj, qmin, qmax, jnp.int32)
    np.testing.assert_array_equal(qi_t.numpy(), np.asarray(qi_j))
    np.testing.assert_array_equal(tq.dequantize_int(qi_t, st, zt).numpy(),
                                  np.asarray(jq.dequantize_int(qi_j, sj, zj)))


# --------------------------------------------------------------------------
# observers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["minmax", "ema"])
def test_observers_bit_exact_per_tensor_and_per_channel(kind):
    """Three batches, the first one seeding. Per-out-channel conv stats
    reduce HWIO axes (0, 1, 2) in JAX and OIHW axes (1, 2, 3) here."""
    upd_j = jobs.minmax_update if kind == "minmax" else jobs.ema_minmax_update
    upd_t = tobs.minmax_update if kind == "minmax" else tobs.ema_minmax_update
    sj = jobs.init_minmax_state((1,))
    st = tobs.init_minmax_state((1,))
    cj = jobs.init_minmax_state((1, 1, 1, 6))
    ct = tobs.init_minmax_state((6, 1, 1, 1))
    for i in range(3):
        x = _np(10 + i, (2, 5, 5, 6), 1.0 + i)
        sj, st = upd_j(sj, jnp.asarray(x)), upd_t(st, torch.from_numpy(x))
        cj = upd_j(cj, jnp.asarray(x), (0, 1, 2))
        ct = upd_t(ct, torch.from_numpy(x.transpose(3, 2, 0, 1)), (1, 2, 3))
        for a, b in ((st, sj), (ct, cj)):
            np.testing.assert_array_equal(a.min_val.numpy().reshape(-1),
                                          np.asarray(b.min_val).reshape(-1))
            np.testing.assert_array_equal(a.max_val.numpy().reshape(-1),
                                          np.asarray(b.max_val).reshape(-1))
            assert bool(a.initialized) and bool(b.initialized)


# --------------------------------------------------------------------------
# IAO layers: the same weights and inputs through both packages
# --------------------------------------------------------------------------


def _load(port_layer, jax_layer):
    port_layer.load_state_dict(cnn_state_from_numpy(_flat(jax_layer)), strict=True)


def _assert_state_close(port_layer, jax_layer, atol):
    """Every variable of the JAX layer against the port's buffer or
    parameter of the same name."""
    ref = cnn_state_from_numpy(_flat(jax_layer))
    got = port_layer.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v.dtype == torch.bool:
            assert torch.equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


# Outputs of size ~1. The layers differ only in the f32 summation order of
# the convolution (measured differences ~1e-7); in training the batch
# statistics it produces fold into the weights before their fake-quant,
# so the weight scales may differ in the last bit, which can move a
# weight code at a .5 boundary: 1e-4 leaves room for a few such moves.
_LAYER_ATOL = 1e-4
# running statistics and observer ranges derived from those sums
_STATE_ATOL = 1e-5


@pytest.mark.parametrize("calib", [False, True])
def test_quant_bn_fuse_conv2d_train_and_eval_match_jax(calib):
    jcfg = JQuantConfig(a_bits=8, w_bits=8, bn_fuse=True, bn_fuse_calib=calib)
    tcfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True, bn_fuse_calib=calib)
    jl = jqat.QuantBNFuseConv2d(6, 8, 3, stride=1, padding=1, bias=True, cfg=jcfg,
                                rngs=nnx.Rngs(0))
    tl = tqat.QuantBNFuseConv2d(6, 8, 3, stride=1, padding=1, bias=True, cfg=tcfg,
                                device="cpu")
    _load(tl, jl)
    for i in range(3):  # training: batch stats seed, then EMA
        x = _np(20 + i, (2, 7, 7, 6), 1.0 + 0.5 * i)
        with torch.no_grad():
            out_t = tl(_nchw(x))
        out_j = np.asarray(jl(jnp.asarray(x)))
        np.testing.assert_allclose(_nhwc(out_t), out_j, rtol=0, atol=_LAYER_ATOL)
    _assert_state_close(tl, jl, _STATE_ATOL)
    assert bool(tl.bn_initialized)
    jl.set_attributes(training=False, raise_if_not_found=False)
    tl.eval()
    x = _np(30, (2, 7, 7, 6))
    with torch.no_grad():
        out_t = tl(_nchw(x))
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(jl(jnp.asarray(x))), rtol=0,
                               atol=_LAYER_ATOL)


def test_quant_linear_per_column_matches_jax():
    jl = jqat.QuantLinear(24, 10, cfg=JQuantConfig(a_bits=4, w_bits=4), rngs=nnx.Rngs(1))
    tl = tqat.QuantLinear(24, 10, cfg=QuantConfig(a_bits=4, w_bits=4), device="cpu")
    _load(tl, jl)
    for i in range(3):
        x = _np(40 + i, (5, 24), 1.0 + i)
        with torch.no_grad():
            out_t = tl(torch.from_numpy(x)).numpy()
        # the same fake-quant codes on both sides; matmul sums in another order
        np.testing.assert_allclose(out_t, np.asarray(jl(jnp.asarray(x))), rtol=0, atol=1e-5)
    # observers and qparams see identical values: bit for bit
    _assert_state_close(tl, jl, 0.0)
    assert tuple(tl.weight_quantizer.scale.shape) == (1, 10)


def test_quant_add_union_scale_bit_exact():
    jl = jqat.QuantAdd(cfg=JQuantConfig(a_bits=8, w_bits=8))
    tl = tqat.QuantAdd(cfg=QuantConfig(a_bits=8, w_bits=8), device="cpu")
    for i in range(3):
        a, b = _np(50 + i, (2, 4, 4, 3), 2.0), _np(60 + i, (2, 4, 4, 3), 0.5)
        out_t = tl(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(out_t, np.asarray(jl(jnp.asarray(a), jnp.asarray(b))))
    _assert_state_close(tl, jl, 0.0)
    aq = tl.activation_quantizer
    assert torch.equal(aq.max_val, torch.maximum(tl.observer_res.max_val,
                                                 tl.observer_shortcut.max_val))
    # eval mode freezes every observer
    tl.eval()
    before = {k: v.clone() for k, v in tl.state_dict().items()}
    tl(torch.from_numpy(_np(70, (2, 4, 4, 3), 9.0)), torch.zeros(2, 4, 4, 3))
    assert all(torch.equal(before[k], v) for k, v in tl.state_dict().items())


def test_ptq_and_other_methods_raise_not_ported():
    """PTQ and DoReFa are ported now (tests/test_torch_calibrate.py,
    tests/test_torch_dorefa.py): ``ptq=True`` builds the histogram or
    entropy observers, symmetric, and ``prepare(method="dorefa")`` runs.
    DoReFa's ``QuantConvTranspose2d`` is a transposed conv now
    (tests/test_torch_convt_concat.py holds it against JAX): it upsamples
    with torch's weight layout. An entropy observer per channel raises."""
    from micronet_tpu_torch.nn import modules as M
    from micronet_tpu_torch.nn import prepare, qat_dorefa
    from micronet_tpu_torch.nn.modules import Linear

    lin = tqat.QuantLinear(4, 4, cfg=QuantConfig(ptq=True, q_type=1), device="cpu")
    assert lin.activation_quantizer.observer == "histogram"
    assert lin.activation_quantizer.symmetric and lin.weight_quantizer.symmetric
    kl = tqat.QuantLinear(4, 4, cfg=QuantConfig(ptq=True, ptq_observer="kl"), device="cpu")
    assert kl.activation_quantizer.ent_counts.shape == (2048,)
    assert type(prepare(Linear(4, 4, device="cpu"), method="dorefa", device="cpu")) is Linear
    up = qat_dorefa.QuantConvTranspose2d(4, 6, 4, stride=2, padding=1, cfg=QuantConfig(),
                                         device="cpu")
    assert isinstance(up, M.ConvTranspose2d) and up.weight.shape == (4, 6, 4, 4)
    assert up(torch.ones(1, 4, 5, 5)).shape == (1, 6, 10, 10)
    with pytest.raises(ValueError, match="per-tensor"):
        tqat.FakeQuantizer(8, observer="entropy", stat_shape=(4, 1, 1, 1), device="cpu")
