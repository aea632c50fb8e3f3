"""Shared flow of the engine tests (``test_torch_engine*.py``: ResNet,
NIN-GC, the asymmetric recipe and the small nets of the engine matrix):
the IAO engine path of the port against the JAX package, stage by stage
(float model -> ``prepare`` -> calibration -> ``fuse_bn_iao`` ->
``freeze_int`` -> engine).

The JAX weights move to the port through ``cnn_state_from_numpy`` (given
the port model, which names its transposed-conv kernels). After
calibration each stage starts from the JAX state of the stage before it,
so every comparison isolates one stage. On the CPU the JAX side
dominates the time, so each file builds its model's flow once.
"""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from micronet_tpu.infer import freeze_int as jfreeze
from micronet_tpu.infer import fuse_bn_iao as jfuse
from micronet_tpu.infer.engine import IntConv2d as JIntConv2d
from micronet_tpu.infer.engine import IntConvTranspose2d as JIntConvTranspose2d
from micronet_tpu.infer.engine import IntLinear as JIntLinear
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
from micronet_tpu_torch.infer.engine import IntConv2d, IntConvTranspose2d, IntLinear
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.ops import int_matmul as tim8
from micronet_tpu_torch.quant.config import QuantConfig

CALIB_BATCHES = 3

# The float models differ from JAX only in the f32 summation order of
# convolutions (~1e-6 relative per layer); logits are of size ~1.
FLOAT_ATOL = 1e-4
# A fake-quant or engine model: where sums before a quantizer differ in
# the last bit, an activation code on a .5 boundary can move by one step
# (1/128 of the layer's range at A8), which reaches the logits damped by
# the layers after it. The engine's integer convolutions are exact on
# both sides; its first layer convolves dequantized values in f32.
QUANT_ATOL = 2e-2


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


class Flow:
    """Both packages' models at every stage of one configuration."""

    def __init__(self, jmodel, tmodel, cfg_kw, shape, state_rtol):
        jcfg, tcfg = JQuantConfig(**cfg_kw), QuantConfig(**cfg_kw)
        # tolerance on the calibrated state, relative to max(1, |value|)
        self.state_rtol = state_rtol
        self.x = _x(99, shape)
        jeval(jmodel)
        self.jfloat_out = np.asarray(jmodel(jnp.asarray(self.x)))
        self.tfloat = tmodel
        self.float_load_keys = tmodel.load_state_dict(cnn_state_from_numpy(_flat(jmodel),
                                                                           tmodel))
        eval_mode(tmodel)
        # prepare and calibrate both from the same float weights
        self.jq = jprepare(jmodel, jcfg, method="iao")
        self.jq_initial = _flat(self.jq)
        self.tq = prepare(tmodel, tcfg, device="cpu")
        self.tq_initial = {k: v.clone() for k, v in self.tq.state_dict().items()}
        jtrain(self.jq)
        train_mode(self.tq)
        for i in range(CALIB_BATCHES):
            xb = _x(10 + i, shape)
            self.jq(jnp.asarray(xb))
            run(self.tq, xb)
        jeval(self.jq)
        eval_mode(self.tq)
        self.jq_calibrated = _flat(self.jq)
        self.tq_calibrated = {k: v.clone() for k, v in self.tq.state_dict().items()}
        self.jq_out = np.asarray(self.jq(jnp.asarray(self.x)))
        # from here on the port starts each stage from JAX's state
        self.tq.load_state_dict(cnn_state_from_numpy(self.jq_calibrated, self.tq))
        self.tq_out = run(self.tq, self.x)
        self.jfused = jfuse(self.jq, jcfg)
        jeval(self.jfused)
        self.jfused_out = np.asarray(self.jfused(jnp.asarray(self.x)))
        self.tfused = fuse_bn_iao(self.tq, tcfg, device="cpu")
        eval_mode(self.tfused)
        self.tfused_out = run(self.tfused, self.x)
        self.jeng = jfreeze(self.jfused, example_input=jnp.asarray(self.x[:1]))
        jeval(self.jeng)
        self.jeng_out = np.asarray(self.jeng(jnp.asarray(self.x)))
        self.teng = freeze_int(self.tfused, example_input=torch.from_numpy(self.x[:1]),
                               device="cpu")
        eval_mode(self.teng)
        n0 = tim8.int8_matmul_dequant.launches
        self.teng_out = run(self.teng, self.x)
        self.launches = tim8.int8_matmul_dequant.launches - n0


def check_float_model(flow):
    keys = flow.float_load_keys
    assert not keys.missing_keys and not keys.unexpected_keys
    np.testing.assert_allclose(run(flow.tfloat, flow.x), flow.jfloat_out, rtol=0,
                               atol=FLOAT_ATOL)


def check_prepared_state(flow):
    """``prepare`` builds the same tree: every JAX variable has its port
    buffer or parameter of the same name, and before calibration every
    value is equal bit for bit."""
    ref = cnn_state_from_numpy(flow.jq_initial, flow.tq)
    assert set(flow.tq_initial) == set(ref)
    for k, v in ref.items():
        assert torch.equal(flow.tq_initial[k], v), k


def check_calibration_state(flow):
    """Observer ranges, qparams and running BN statistics after the
    calibration forwards."""
    for k, v in cnn_state_from_numpy(flow.jq_calibrated, flow.tq).items():
        got = flow.tq_calibrated[k]
        if v.dtype == torch.bool:
            assert torch.equal(got, v), k
        else:
            atol = flow.state_rtol * max(1.0, v.abs().max().item())
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def check_prepared_and_fused_logits(flow):
    for got, ref in ((flow.tq_out, flow.jq_out), (flow.tfused_out, flow.jfused_out)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=QUANT_ATOL)
        assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    # the fusion itself: the fused model keeps the eval-mode prediction
    np.testing.assert_allclose(flow.tfused_out, flow.tq_out, rtol=0, atol=QUANT_ATOL)


def check_fused_state(flow):
    """Folded weights and biases, pre-quantized weights and the carried
    quantizer state: the same f32 operations on the same state."""
    ref = cnn_state_from_numpy(_flat(flow.jfused), flow.tfused)
    got = flow.tfused.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def check_frozen_weights(flow):
    jl = {".".join(map(str, p)): m for p, m in nnx.iter_modules(flow.jeng)
          if isinstance(m, (JIntConv2d, JIntConvTranspose2d, JIntLinear))}
    tl = {n: m for n, m in flow.teng.named_modules()
          if isinstance(m, (IntConv2d, IntConvTranspose2d, IntLinear))}
    assert set(tl) == set(jl) and tl
    for name, t in tl.items():
        j = jl[name]
        assert getattr(t, "w_packed", False) == getattr(j, "w_packed", False), name
        assert (t.symmetric, t.w_symmetric) == (j.symmetric, j.w_symmetric), name
        w_t = t.w_q
        if isinstance(t, IntConv2d) and not t.w_packed:
            w_t = w_t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif isinstance(t, IntConvTranspose2d):
            w_t = w_t.permute(2, 3, 0, 1)  # (in, out/g, kh, kw) -> (kh, kw, in, out/g)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(j.w_q[...]), err_msg=name)
        for attr in ("w_scale", "act_scale", "act_zero_point", "w_zp"):
            np.testing.assert_array_equal(getattr(t, attr).numpy(),
                                          np.asarray(getattr(j, attr)[...]), err_msg=name)
        assert (t.a_qmin, t.a_qmax) == (j.a_qmin, j.a_qmax)
        if j.bias is not None:
            np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias[...]))
        if isinstance(t, IntConv2d):
            assert t.f32_dequant == j.f32_dequant
            np.testing.assert_array_equal(t.out_scale.numpy(), np.asarray(j.out_scale[...]))


def check_engine_state(flow):
    """The JAX engine's state, carried by ``cnn_state_from_numpy``, has
    exactly the port engine's names and equals its own frozen state bit
    for bit: codes, scales, zero points, the unfrozen quantizers'."""
    ref = cnn_state_from_numpy(_flat(flow.jeng), flow.teng)
    got = flow.teng.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def check_chained_layers(flow):
    got = sorted(n for n, m in flow.teng.named_modules() if getattr(m, "chained", False))
    ref = sorted(".".join(map(str, p)) for p, m in nnx.iter_modules(flow.jeng)
                 if getattr(m, "chained", False))
    assert got == ref and got


def check_engine_logits(flow):
    np.testing.assert_allclose(flow.teng_out, flow.jeng_out, rtol=0, atol=QUANT_ATOL)
    assert np.array_equal(flow.teng_out.argmax(-1), flow.jeng_out.argmax(-1))
    # and the engine against the fake-quant model it was frozen from
    np.testing.assert_allclose(flow.teng_out, flow.tfused_out, rtol=0, atol=QUANT_ATOL)


CHECKS = [check_float_model, check_prepared_state, check_calibration_state,
          check_prepared_and_fused_logits, check_fused_state, check_frozen_weights,
          check_engine_state, check_chained_layers, check_engine_logits]
