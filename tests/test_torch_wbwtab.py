"""The wbwtab flow of the port against the JAX package: the sign and
ternary STEs, ``quantize_weight``, ``prepare(method="wbwtab")``,
``fuse_bn_wbwtab`` (gamma > 0, < 0 and == 0), ``freeze_wbwtab`` and the
ternary engine, on a small NIN (``cfg=[8] * 8``) and NIN-GC
(``cfg=[32] * 8``) at batch 2 to 4.

Inputs are made with numpy and go through both packages; weights move
from JAX to the port through ``cnn_state_from_numpy``. From the fused
stage on, the port starts from JAX's state of the stage before, so each
comparison isolates one stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.infer import freeze_wbwtab as jfreeze
from micronet_tpu.infer import fuse_bn_wbwtab as jfuse
from micronet_tpu.infer.engine import TernaryConv2d as JTernaryConv2d
from micronet_tpu.models import nin as jnin
from micronet_tpu.models import nin_gc as jnin_gc
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import functional as JF
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import qat_wbwtab as jqw
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant import rounding as jr
from micronet_tpu.quant import wbwtab as jwb
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.infer import freeze_wbwtab, fuse_bn_wbwtab
from micronet_tpu_torch.infer.engine import TernaryConv2d
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.models import nin_gc as tnin_gc
from micronet_tpu_torch.nn import eval_mode, prepare, qat_wbwtab, train_mode
from micronet_tpu_torch.nn import functional as TFn
from micronet_tpu_torch.nn import modules as M
from micronet_tpu_torch.quant import rounding as tr
from micronet_tpu_torch.quant import wbwtab as twb
from micronet_tpu_torch.quant.config import QuantConfig

# Float convolutions of the two packages sum in another f32 order (~1e-6
# relative); the tiny models' logits are of size ~1.
FLOAT_ATOL = 1e-4
# f32 means over a channel in another order: an ulp or two
MEAN_RTOL = 1e-6
# The JAX package's own bound between the engine and the fused model
# (tests/test_infer.py:138-141)
ENGINE_ATOL, ENGINE_RTOL = 2e-3, 1e-3


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w_hwio).transpose(3, 2, 0, 1)))


def _hwio(w_oihw):
    return w_oihw.detach().numpy().transpose(2, 3, 1, 0)


# --------------------------------------------------------------------------
# rounding: the sign and ternary STEs
# --------------------------------------------------------------------------

_EDGES = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 0.999, -0.999, 1.5, -2.0, 0.3, -0.3],
                  np.float32)


def _edge_input():
    return np.concatenate([_EDGES, _np(1, (52,))]).reshape(8, 8)


@pytest.mark.parametrize("name", ["binary_act", "binary_weight", "ternary"])
def test_sign_stes_forward_and_gradient_match_jax(name):
    """Forward bit for bit (0 and -0.0 give +1: not ``torch.sign``),
    gradient equal to ``jax.grad``'s: the saturate-STE's strict mask for
    ``binary_act``, identity for the other two, none to the threshold."""
    x = _edge_input()
    g = _np(2, x.shape)
    thr = np.full((8, 1), 0.3, np.float32)
    if name == "ternary":
        jf = lambda v: jr.ternary(v, jnp.asarray(thr))
        tf = lambda v: tr.ternary(v, torch.from_numpy(thr))
    else:
        jf, tf = getattr(jr, name), getattr(tr, name)
    ref = np.asarray(jf(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tf(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    np.testing.assert_array_equal(xt.grad.numpy(), jgrad)
    if name != "ternary":
        assert out[0, 0] == 1 and out[0, 1] == 1  # 0 and -0.0


def test_ternary_threshold_gets_no_gradient():
    thr = torch.full((4, 1), 0.3, requires_grad=True)
    x = torch.from_numpy(_np(3, (4, 6))).requires_grad_(True)
    tr.ternary(x, thr).sum().backward()
    assert thr.grad is None or torch.all(thr.grad == 0)
    assert torch.all(x.grad == 1)


# --------------------------------------------------------------------------
# quant/wbwtab.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("W", [2, 3, 32])
def test_quantize_weight_matches_jax(W):
    """HWIO in JAX, OIHW in the port: the same codes, alpha within an ulp
    or two (f32 means in another order), and the same new master."""
    w = _np(10 + W, (3, 3, 8, 6), 0.4)
    qj, mj = (np.asarray(a) for a in jwb.quantize_weight(jnp.asarray(w), W))
    qt, mt = twb.quantize_weight(_oihw(w), W)
    qt, mt = _hwio(qt), _hwio(mt)
    if W == 32:
        np.testing.assert_array_equal(qt, w)
        np.testing.assert_array_equal(mt, w)
        return
    np.testing.assert_array_equal(np.sign(qt), np.sign(qj))
    alpha_t, alpha_j = np.abs(qt).max((0, 1, 2)), np.abs(qj).max((0, 1, 2))
    np.testing.assert_allclose(alpha_t, alpha_j, rtol=MEAN_RTOL, atol=0)
    np.testing.assert_allclose(qt, qj, rtol=MEAN_RTOL, atol=0)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=MEAN_RTOL)
    if W == 3:
        assert np.any(qt == 0) and np.all(np.isin(np.sign(qt), [-1, 0, 1]))
        # the threshold: 0.7 * E(|w|) per out channel, equal within the same bound
        np.testing.assert_allclose(
            0.7 * np.abs(w).mean((0, 1, 2)),
            0.7 * torch.from_numpy(np.abs(w)).mean((0, 1, 2)).numpy(), rtol=MEAN_RTOL)


def test_ternary_fully_pruned_channel_gives_nan_alpha_as_jax():
    w = _np(20, (1, 1, 8, 4))
    w[..., 2] = 0.0  # out channel 2 all zeros: no |w| above its threshold
    qj = np.asarray(jwb.quantize_weight(jnp.asarray(w), 3)[0])
    qt = _hwio(twb.quantize_weight(_oihw(w), 3)[0])
    assert np.all(np.isnan(qj[..., 2])) and np.all(np.isnan(qt[..., 2]))
    np.testing.assert_allclose(qt[..., [0, 1, 3]], qj[..., [0, 1, 3]], rtol=MEAN_RTOL)


def test_quantize_activation_matches_jax():
    x = _edge_input()
    for A in (2, 32):
        np.testing.assert_array_equal(
            twb.quantize_activation(torch.from_numpy(x), A).numpy(),
            np.asarray(jwb.quantize_activation(jnp.asarray(x), A)))


def test_project_params_matches_jax():
    """The W == 2 write-back of the centred, clamped weight; W == 3 convs
    are left alone."""
    from micronet_tpu_torch.nn.qat_wbwtab import project_params

    for W in (2, 3):
        jc = jqw.QuantConv2d(8, 6, 3, padding=1, cfg=JQuantConfig(W=W), rngs=nnx.Rngs(0))
        tc = qat_wbwtab.QuantConv2d(8, 6, 3, padding=1, cfg=QuantConfig(W=W), device="cpu")
        w = _np(30, (3, 3, 8, 6), 1.5)
        jc.weight[...] = jnp.asarray(w)
        with torch.no_grad():
            tc.weight.copy_(_oihw(w))
        jqw.project_params(jc)
        project_params(tc)
        got, ref = _hwio(tc.weight), np.asarray(jc.weight[...])
        np.testing.assert_allclose(got, ref, rtol=0, atol=MEAN_RTOL)
        assert (W == 3) == np.array_equal(got, w)


# --------------------------------------------------------------------------
# prepare -> fuse_bn_wbwtab -> freeze_wbwtab
# --------------------------------------------------------------------------
#
# A binary net amplifies the last bit: a pre-sign value within an f32
# rounding of 0 can take the other sign when the two packages sum a conv
# in another order, and one flipped sign moves every logit after it. So
# the flows compare block by block ("teacher forcing"): each block of the
# port gets JAX's input to that block, its pre-activation must agree
# within FLOAT_ATOL and its signs must be equal wherever JAX's
# pre-activation is farther than FLIP_EPS from 0. Calibration runs the
# same way, so the BN statistics see the same inputs.

_NETS = {
    "nin": (lambda: jnin.Net(cfg=[8] * 8, rngs=nnx.Rngs(0)),
            lambda: tnin.Net(cfg=[8] * 8, device="cpu")),
    "nin_gc": (lambda: jnin_gc.Net(cfg=[32] * 8, rngs=nnx.Rngs(0)),
               lambda: tnin_gc.Net(cfg=[32] * 8, device="cpu")),
}
FLIP_EPS = 1e-4


def _kinds(jmodel, tmodel):
    """Module type names by path in both trees (paths joined with dots)."""
    j = {".".join(map(str, p)): type(m).__name__ for p, m in nnx.iter_modules(jmodel)
         if p and type(m).__name__ != "List"}
    t = {n: type(m).__name__ for n, m in tmodel.named_modules()
         if n and type(m).__name__ != "ModuleList"}
    return j, t


def _jax_block(layer, h):
    """(pre-activation, output) of one JAX block on the NHWC numpy ``h``."""
    x = jnp.asarray(h)
    if not hasattr(layer, "conv"):
        out = np.asarray(layer(x))
        return out, out
    if getattr(layer, "channel_shuffle_flag", 0):
        x = JF.channel_shuffle(x, layer.shuffle_groups)
    pre = layer.bn(layer.conv(x))
    return np.asarray(pre), np.asarray(layer.relu(pre))


def _torch_block(layer, h):
    """(pre-activation, output) of one port block on the NHWC numpy ``h``."""
    nhwc = lambda t: t.numpy().transpose(0, 2, 3, 1)
    x = torch.from_numpy(np.ascontiguousarray(h.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        if not hasattr(layer, "conv"):
            out = nhwc(layer(x))
            return out, out
        if getattr(layer, "channel_shuffle_flag", 0):
            x = TFn.channel_shuffle(x, layer.shuffle_groups)
        pre = layer.bn(layer.conv(x))
        return nhwc(pre), nhwc(layer.relu(pre))


def _teacher_forced(run_a, model_a, run_b, model_b, x, pre_atol=FLOAT_ATOL):
    """Both models block by block, every block of ``b`` fed ``a``'s input
    to it. Asserts, per block: pre-activations within ``pre_atol`` (None:
    not compared), signs equal except where |a's pre-activation| <=
    FLIP_EPS, the classifier's output within FLOAT_ATOL. Returns both
    final outputs (N, classes)."""
    h = x
    layers_a, layers_b = list(model_a.model.layers), list(model_b.model.layers)
    for i, (la, lb) in enumerate(zip(layers_a, layers_b)):
        pa, oa = run_a(la, h)
        pb, ob = run_b(lb, h)
        binary = hasattr(lb, "relu") and isinstance(lb.relu, qat_wbwtab.ActivationQuantizer)
        if pre_atol is not None:
            np.testing.assert_allclose(pb, pa, rtol=0, atol=pre_atol, err_msg=f"block {i}")
        if binary or not hasattr(lb, "conv"):
            diff = oa != ob
            assert np.all(np.abs(pa[diff]) <= FLIP_EPS), f"block {i}"
        else:
            np.testing.assert_allclose(ob, oa, rtol=0, atol=FLOAT_ATOL, err_msg=f"block {i}")
        h = oa
    return oa.reshape(x.shape[0], -1), ob.reshape(x.shape[0], -1)


class WbwtabFlow:
    """Both packages' models at every stage of one wbwtab configuration."""

    def __init__(self, net, W, calib=3, batch=2, set_gammas=True):
        jbuild, tbuild = _NETS[net]
        jcfg, self.cfg = JQuantConfig(W=W, A=2), QuantConfig(W=W, A=2)
        jmodel, tmodel = jbuild(), tbuild()
        tmodel.load_state_dict(cnn_state_from_numpy(_flat(jmodel)))
        self.jq = jprepare(jmodel, jcfg, method="wbwtab")
        self.tq = prepare(tmodel, self.cfg, method="wbwtab", device="cpu")
        self.kinds = _kinds(self.jq, self.tq)
        self.jq_initial = _flat(self.jq)
        self.tq_initial = {k: v.clone() for k, v in self.tq.state_dict().items()}
        shape = (batch, 32, 32, 3)
        jtrain(self.jq)
        train_mode(self.tq)
        for i in range(calib):
            _teacher_forced(_jax_block, self.jq, _torch_block, self.tq, _np(40 + i, shape))
        jeval(self.jq)
        eval_mode(self.tq)
        self.jq_calibrated = _flat(self.jq)
        self.tq_calibrated = {k: v.clone() for k, v in self.tq.state_dict().items()}
        self.x = _np(99, shape)
        self.jq_out, self.tq_out = _teacher_forced(_jax_block, self.jq, _torch_block, self.tq,
                                                   self.x)
        if set_gammas:
            self._set_gammas()
        # from here on the port starts each stage from JAX's state
        self.tq.load_state_dict(cnn_state_from_numpy(_flat(self.jq)))
        self.tq_loaded = {k: v.clone() for k, v in self.tq.state_dict().items()}
        self.jfused = jfuse(self.jq, jcfg)
        jeval(self.jfused)
        self.tfused = eval_mode(fuse_bn_wbwtab(self.tq, self.cfg, device="cpu"))
        self.jfused_out, self.tfused_out = _teacher_forced(_jax_block, self.jfused, _torch_block,
                                                           self.tfused, self.x)
        self.tfused_from_jax = eval_mode(fuse_bn_wbwtab(self.tq, self.cfg, device="cpu"))
        self.tfused_from_jax.load_state_dict(cnn_state_from_numpy(_flat(self.jfused)))
        self.jeng = jfreeze(self.jfused)
        jeval(self.jeng)
        self.teng = eval_mode(freeze_wbwtab(self.tfused_from_jax, device="cpu"))
        self.jeng_out = np.asarray(self.jeng(jnp.asarray(self.x)))
        self.teng_out = _run(self.teng, self.x)

    def _set_gammas(self):
        """Every BN gets channels with gamma > 0, < 0 and == 0 (and a beta
        away from 0), set by hand in the JAX model."""
        for i, (path, m) in enumerate(nnx.iter_modules(self.jq)):
            if type(m).__name__ == "BatchNorm2d":
                c = m.weight[...].shape[0]
                g = np.random.default_rng(60 + i).uniform(0.5, 1.5, c).astype(np.float32)
                g[1::3] *= -1
                g[2::5] = 0.0
                m.weight[...] = jnp.asarray(g)
                m.bias[...] = jnp.asarray(_np(70 + i, (c,), 0.3))


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def nin_flow(request):
    return WbwtabFlow("nin", request.param)


@pytest.fixture(scope="module")
def nin_gc_flow():
    # gammas as trained (all 1): the fusion must keep the eval prediction
    return WbwtabFlow("nin_gc", 3, calib=2, set_gammas=False)


def test_prepare_swaps_the_same_modules_as_jax(nin_flow, nin_gc_flow):
    """Convs 2..8 become QuantConv2d, the ReLUs after convs 1..8 become
    ActivationQuantizer, conv 1 and 9 and the last ReLU stay; the state is
    the same, value for value."""
    for flow in (nin_flow, nin_gc_flow):
        j, t = flow.kinds
        assert t == j
        kinds = list(t.values())
        assert kinds.count("QuantConv2d") == 7 and kinds.count("ActivationQuantizer") == 8
        assert kinds.count("Conv2d") == 2 and kinds.count("ReLU") == 1
        ref = cnn_state_from_numpy(flow.jq_initial)
        assert set(flow.tq_initial) == set(ref)
        for k, v in ref.items():
            assert torch.equal(flow.tq_initial[k], v), k


def test_prepared_forwards_and_bn_statistics_match_jax(nin_flow, nin_gc_flow):
    """Calibration in train mode and the eval forward, block by block from
    the same inputs (asserted inside the flow: a sign may differ only where
    the pre-activation is within FLIP_EPS of 0, as on a channel that is
    constant over the batch, which train-mode BN maps to about +-1e-6);
    the running statistics after calibration within 1e-5."""
    for flow in (nin_flow, nin_gc_flow):
        np.testing.assert_allclose(flow.tq_out, flow.jq_out, rtol=0, atol=FLOAT_ATOL)
        for k, v in cnn_state_from_numpy(flow.jq_calibrated).items():
            atol = 1e-5 * max(1.0, v.abs().max().item())
            np.testing.assert_allclose(flow.tq_calibrated[k].numpy(), v.numpy(), rtol=0,
                                       atol=atol, err_msg=k)


def test_fuse_bn_wbwtab_matches_jax_with_signed_gammas(nin_flow):
    """Biases bit for bit (gamma > 0: bias only; < 0: the mirrored bias;
    == 0: untouched; past the binary range the standard fold), the plain
    convs' weights bit for bit (conv 1 negated where gamma < 0), the
    pre-quantized convs' codes equal and values within an ulp or two."""
    ref = cnn_state_from_numpy(_flat(nin_flow.jfused))
    got = nin_flow.tfused.state_dict()
    assert set(got) == set(ref)
    quant = {n + ".weight" for n, m in nin_flow.tfused.named_modules()
             if isinstance(m, qat_wbwtab.QuantConv2d)}
    assert len(quant) == 7
    for k, v in ref.items():
        if k in quant:
            np.testing.assert_array_equal(np.sign(got[k].numpy()), np.sign(v.numpy()), k)
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=MEAN_RTOL, err_msg=k)
        else:
            assert torch.equal(got[k], v), k
    # conv 1 is in the binary range: where gamma < 0 its weights are negated
    gamma = nin_flow.tq_loaded["model.layers.0.bn.weight"]
    w0 = nin_flow.tq_loaded["model.layers.0.conv.weight"]
    neg = gamma < 0
    assert neg.any() and (gamma == 0).any() and (gamma > 0).any()
    assert torch.equal(got["model.layers.0.conv.weight"][neg], -w0[neg])
    assert torch.equal(got["model.layers.0.conv.weight"][~neg], w0[~neg])
    assert not any(isinstance(m, M.BatchNorm2d) for m in nin_flow.tfused.modules())


def test_fused_model_matches_jax_and_keeps_the_eval_prediction(nin_flow, nin_gc_flow):
    """The fused models block by block (asserted inside the flow); with no
    gamma == 0, the fused model's signs are the prepared model's (BN ->
    bias keeps every sign) and its logits the prepared model's within the
    JAX package's bound (tests/test_infer.py:84-86)."""
    for flow in (nin_flow, nin_gc_flow):
        np.testing.assert_allclose(flow.tfused_out, flow.jfused_out, rtol=0, atol=FLOAT_ATOL)
    prepared, fused = _teacher_forced(_torch_block, nin_gc_flow.tq, _torch_block,
                                      nin_gc_flow.tfused, nin_gc_flow.x, pre_atol=None)
    np.testing.assert_allclose(fused, prepared, rtol=1e-4, atol=5e-4)


def test_freeze_wbwtab_codes_and_alpha_equal_jax(nin_flow):
    jl = {".".join(map(str, p)): m for p, m in nnx.iter_modules(nin_flow.jeng)
          if isinstance(m, JTernaryConv2d)}
    tl = {n: m for n, m in nin_flow.teng.named_modules() if isinstance(m, TernaryConv2d)}
    assert set(tl) == set(jl) and len(tl) == 7
    for name, t in tl.items():
        j = jl[name]
        np.testing.assert_array_equal(_hwio(t.w_t), np.asarray(j.w_t[...]), err_msg=name)
        assert t.w_t.dtype == torch.int8 and set(t.w_t.unique().tolist()) <= {-1, 0, 1}
        np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha[...]))
        np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias[...]))
        assert (t.stride, t.padding, t.groups) == (tuple(j.stride), tuple(j.padding), j.groups)


def test_freeze_wbwtab_fully_pruned_channel_as_jax():
    """A ternary channel with no weight above its threshold has a NaN
    alpha (the reference's quirk, kept); both packages freeze it to codes
    0 and alpha NaN, so the channel's output is NaN in both."""
    from micronet_tpu.nn import modules as JM

    w = _np(21, (1, 1, 8, 4))
    w[..., 2] = 0.0
    q = np.asarray(jwb.quantize_weight(jnp.asarray(w), 3)[0])
    jconv = jqw.QuantConv2d(8, 4, 1, cfg=JQuantConfig(W=3, quant_inference=True),
                            rngs=nnx.Rngs(0))
    jconv.weight[...] = jnp.asarray(q)
    tconv = qat_wbwtab.QuantConv2d(8, 4, 1, cfg=QuantConfig(W=3, quant_inference=True),
                                   device="cpu")
    with torch.no_grad():
        tconv.weight.copy_(_oihw(q))
        tconv.bias.copy_(torch.from_numpy(np.array(jconv.bias[...])))
    j = jfreeze(JM.Sequential(jconv)).layers[0]
    t = freeze_wbwtab(M.Sequential(tconv), device="cpu").layers[0]
    np.testing.assert_array_equal(_hwio(t.w_t), np.asarray(j.w_t[...]))
    np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha[...]))
    assert np.isnan(t.alpha[2].item()) and not t.w_t[2].any()


def test_engine_logits_match_jax_engine(nin_flow, nin_gc_flow):
    """Whole forwards, within the JAX package's own bound between its
    engine and its fused model (tests/test_infer.py:138-141)."""
    for flow in (nin_flow, nin_gc_flow):
        np.testing.assert_allclose(flow.teng_out, flow.jeng_out, rtol=ENGINE_RTOL,
                                   atol=ENGINE_ATOL)
        np.testing.assert_allclose(flow.teng_out, flow.jfused_out, rtol=ENGINE_RTOL,
                                   atol=ENGINE_ATOL)


def test_engine_bit_for_bit_from_the_same_first_block_signs(nin_flow, nin_gc_flow):
    """Feed JAX's first-block signs to both engines: every ternary conv's
    output and every block's signs are equal bit for bit (exact integer
    sums, the same two rounded f32 operations); the logits, past the float
    classifier conv and the average pool (sums in another order), within
    1e-5."""
    for flow in (nin_flow, nin_gc_flow):
        h = _jax_block(flow.jeng.model.layers[0], flow.x)[1]
        assert set(np.unique(h).tolist()) == {-1.0, 1.0}
        layers = list(zip(flow.jeng.model.layers, flow.teng.model.layers))[1:]
        for i, (lj, lt) in enumerate(layers):
            pj, oj = _jax_block(lj, h)
            pt, ot = _torch_block(lt, h)
            if hasattr(lt, "conv") and isinstance(lt.conv, TernaryConv2d):
                np.testing.assert_array_equal(pt, pj, err_msg=f"block {i + 1}")
                np.testing.assert_array_equal(ot, oj, err_msg=f"block {i + 1}")
            elif i < len(layers) - 2:
                np.testing.assert_array_equal(ot, oj, err_msg=f"block {i + 1}")
            else:  # the float classifier and the average pool
                np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5)
            h = oj


# --------------------------------------------------------------------------
# the ternary conv's routes: the card's im2col + _int_mm runs on CPU tensors
# --------------------------------------------------------------------------

# NIN-GC's seven ternary convs at default widths (cin, size, cout, k, pad, groups)
NIN_GC_TERNARY = [(256, 32, 256, 1, 0, 2), (256, 32, 256, 1, 0, 2), (256, 16, 512, 3, 1, 16),
                  (512, 16, 512, 1, 0, 4), (512, 16, 512, 1, 0, 4), (512, 8, 1024, 3, 1, 32),
                  (1024, 8, 1024, 1, 0, 8)]


@pytest.mark.parametrize("cin,size,cout,k,pad,groups", NIN_GC_TERNARY)
def test_ternary_conv_im2col_route_equals_f64_conv(cin, size, cout, k, pad, groups):
    """The card's route (im2col over the int8 signs, block-diagonal weight,
    ``torch._int_mm``) equals the CPU's f64 conv bit for bit; the output
    is ``f32(acc) * alpha + bias``."""
    rng = np.random.default_rng(cin + cout + k)
    w_t = torch.from_numpy(rng.integers(-1, 2, (cout, cin // groups, k, k)).astype(np.int8))
    alpha = torch.from_numpy(rng.uniform(0.1, 1.0, cout).astype(np.float32))
    bias = torch.from_numpy(_np(5, (cout,)))
    conv = TernaryConv2d(w_t, alpha, bias, (1, 1), (pad, pad), (1, 1), groups)
    x = torch.from_numpy(np.where(_np(6, (1, cin, size, size)) >= 0, 1.0, -1.0)
                         .astype(np.float32))
    acc = conv._int_acc_im2col(x.to(torch.int8))
    ref = torch.nn.functional.conv2d(x.double(), w_t.double(), None, 1, pad, 1, groups)
    assert acc.dtype == torch.int32 and torch.equal(acc.double(), ref)
    out = conv(x)
    assert torch.equal(out, ref.float() * alpha[:, None, None] + bias[:, None, None])


def test_prepare_wbwtab_on_nin_keeps_first_and_last_conv_float():
    net = tnin.Net(cfg=[8] * 8, device="cpu")
    q = prepare(net, method="wbwtab", W=3, device="cpu")
    convs = [m for m in q.modules() if isinstance(m, M.Conv2d)]
    assert [type(m).__name__ for m in convs] == ["Conv2d"] + ["QuantConv2d"] * 7 + ["Conv2d"]
    assert all(m.W == 3 and not m.quant_inference for m in convs[1:-1])
    # the original model is untouched
    assert all(type(m) is M.Conv2d for m in net.modules() if isinstance(m, M.Conv2d))
