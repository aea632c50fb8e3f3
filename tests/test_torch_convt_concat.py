"""ConvTranspose2d, LeakyReLU, Sigmoid and Concat in the port against the
JAX package: the float functions and modules, the layout the interop and
the checkpoints give transposed-conv kernels, the QAT layers of IAO,
DoReFa and wbwtab, ``prepare`` of all three methods on a net that holds
every one of them (its first/last-layer and skip rules counting the
transposed conv), ``QuantConcat``'s union scale (streamed, KL-calibrated
and through a QAT backward) and that net's whole IAO engine flow
(``_torch_engine_flow.Flow``: ``IntConvTranspose2d``, ``IntConcat``, the
fake-quant LeakyReLU and Sigmoid between them).

Tolerances: float modules ``FLOAT_ATOL`` (convolutions summed in another
f32 order; ``tanh``-free); fake-quant outputs ``QUANT_ATOL``; quantizer
state within 1e-5 of max(1, |value|) (observers over the same sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_engine_flow import (CHECKS, FLOAT_ATOL, QUANT_ATOL, Flow, _flat, _x, run)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu.infer.bn_fuse import pre_quantize_weights as jpre_quantize
from micronet_tpu.nn import functional as JF
from micronet_tpu.nn import modules as JM
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import qat_iao as jqat
from micronet_tpu.nn import qat_wbwtab as jwb
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.infer import pre_quantize_weights
from micronet_tpu_torch.infer.engine import IntConcat, IntConvTranspose2d
from micronet_tpu_torch.interop import cnn_state_from_numpy, transposed_kernel_keys
from micronet_tpu_torch.nn import functional as TF
from micronet_tpu_torch.nn import modules as TM
from micronet_tpu_torch.nn import prepare, qat_iao, qat_wbwtab, train_mode
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train.checkpoint import arrays_to_state, state_to_arrays

STATE_RTOL = 1e-5


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(tmod, jmod):
    keys = tmod.load_state_dict(cnn_state_from_numpy(_flat(jmod), tmod))
    assert not keys.missing_keys and not keys.unexpected_keys


def _assert_state_close(tmod, jmod):
    for k, v in cnn_state_from_numpy(_flat(jmod), tmod).items():
        got = tmod.state_dict()[k]
        if v.dtype == torch.bool:
            assert torch.equal(got, v), k
        else:
            atol = STATE_RTOL * max(1.0, v.abs().max().item())
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


# (cin, cout, k, stride, padding, output_padding, dilation, groups): UpNet's
# upsampler, output_padding 1, groups 4, dilation 2, and padding past
# d * (k - 1): the JAX package's edge padding is negative there (a crop)
CONVT_CASES = [
    (16, 8, 4, 2, 1, 0, 1, 1),
    (8, 6, 3, 2, 1, 1, 1, 1),
    (8, 12, 3, 2, 0, 0, 1, 4),
    (6, 4, 3, 1, 2, 0, 2, 1),
    (6, 6, 3, 2, 3, 1, 1, 2),
]


@pytest.mark.parametrize("case", CONVT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv_transpose2d_matches_jax(case):
    """``F.conv_transpose2d`` (torch semantics, NCHW, (in, out/g, kh, kw))
    and the ``ConvTranspose2d`` module on the JAX module's own weights."""
    cin, co, k, s, p, op, d, g = case
    x = _np(cin + co, (2, 7, 5, cin))
    jm = JM.ConvTranspose2d(cin, co, k, stride=s, padding=p, output_padding=op, groups=g,
                            dilation=d, rngs=nnx.Rngs(1))
    tm = TM.ConvTranspose2d(cin, co, k, stride=s, padding=p, output_padding=op, groups=g,
                            dilation=d, device="cpu")
    _load(tm, jm)
    w = np.asarray(jm.weight[...])
    assert tuple(tm.weight.shape) == (cin, co // g, k, k)
    ref = np.asarray(JF.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                         jm.bias[...], s, p, op, d, g))
    got = _nhwc(TF.conv_transpose2d(_nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1).copy()),
                                    torch.from_numpy(np.asarray(jm.bias[...])), s, p, op, d, g))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=FLOAT_ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm(jnp.asarray(x))), rtol=0,
                                   atol=FLOAT_ATOL)


def test_activations_and_concat_match_jax():
    """LeakyReLU, Sigmoid and Concat; Concat's NHWC axis -1 (channels) and
    1 (height) concatenate the same values as JAX's."""
    x = _np(3, (2, 4, 5, 3), 4.0)
    y = _np(4, (2, 4, 5, 3))
    for jm, tm in ((JM.LeakyReLU(0.2), TM.LeakyReLU(0.2)), (JM.Sigmoid(), TM.Sigmoid())):
        np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm(jnp.asarray(x))), rtol=0,
                                   atol=FLOAT_ATOL)
    for axis in (-1, 1):
        ref = np.asarray(JM.Concat(axis)(jnp.asarray(x), jnp.asarray(y)))
        got = _nhwc(TM.Concat(axis)(_nchw(x), _nchw(y)))
        np.testing.assert_array_equal(got, ref)
    flat = TM.Concat(-1)(torch.from_numpy(x[:, 0, 0]), torch.from_numpy(y[:, 0, 0]))
    np.testing.assert_array_equal(flat.numpy(), np.concatenate([x[:, 0, 0], y[:, 0, 0]], -1))


def test_kernel_layout_comes_from_the_module():
    """A conv and a transposed conv whose kernels have the same shape (8,
    8, 3, 3: in == out / groups): the interop and the checkpoint take each
    one's layout from its module, not from the shape."""

    class JPair(JM.OrderedModule):
        def __init__(self, *, rngs):
            self.conv = JM.Conv2d(8, 8, 3, padding=1, rngs=rngs)
            self.up = JM.ConvTranspose2d(8, 8, 3, padding=1, rngs=rngs)

        def __call__(self, x):
            return self.up(self.conv(x))

    class TPair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = TM.Conv2d(8, 8, 3, padding=1, device="cpu")
            self.up = TM.ConvTranspose2d(8, 8, 3, padding=1, device="cpu")

        def forward(self, x):
            return self.up(self.conv(x))

    jm, tm = JPair(rngs=nnx.Rngs(2)), TPair()
    assert transposed_kernel_keys(tm) == {"up.weight"}
    _load(tm, jm)
    wc, wt = np.asarray(jm.conv.weight[...]), np.asarray(jm.up.weight[...])
    assert wc.shape == wt.shape == (3, 3, 8, 8)
    np.testing.assert_array_equal(tm.conv.weight.detach().numpy(), wc.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tm.up.weight.detach().numpy(), wt.transpose(2, 3, 0, 1))
    x = _np(5, (2, 6, 6, 8))
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm(jnp.asarray(x))), rtol=0,
                                   atol=FLOAT_ATOL)
    # the checkpoint format is the JAX package's layout, both ways
    arrays = state_to_arrays(tm)
    np.testing.assert_array_equal(arrays["up/weight/.value"], wt)
    np.testing.assert_array_equal(arrays["conv/weight/.value"], wc)
    fresh = TPair()
    arrays_to_state(fresh, arrays)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                 tm.state_dict().values()))


# ---------------------------------------------------------------- QAT layers


@pytest.mark.parametrize("q_type", [0, 1])
def test_iao_layers_match_jax(q_type):
    """IAO ``QuantConvTranspose2d`` (per-layer weight quantizer whatever
    ``q_level``), ``QuantLeakyReLU`` and ``QuantSigmoid``: three training
    forwards, then eval; outputs within QUANT_ATOL, quantizer state within
    1e-5."""
    jcfg, tcfg = JQuantConfig(q_type=q_type, q_level=0), QuantConfig(q_type=q_type, q_level=0)
    pairs = [
        (jqat.QuantConvTranspose2d(8, 6, 4, stride=2, padding=1, cfg=jcfg, rngs=nnx.Rngs(0)),
         qat_iao.QuantConvTranspose2d(8, 6, 4, stride=2, padding=1, cfg=tcfg, device="cpu"), 8),
        (jqat.QuantLeakyReLU(0.1, cfg=jcfg), qat_iao.QuantLeakyReLU(0.1, cfg=tcfg, device="cpu"),
         5),
        (jqat.QuantSigmoid(jcfg), qat_iao.QuantSigmoid(tcfg, "cpu"), 5),
    ]
    for jl, tl, c in pairs:
        _load(tl, jl)
        assert type(tl).__name__ == type(jl).__name__
        if hasattr(tl, "weight_quantizer"):
            assert tuple(tl.weight_quantizer.scale.shape) == (1,)
            assert tl.weight_quantizer.symmetric == (q_type == 0)
        tl.train()
        for i in range(3):
            x = _np(20 + i, (2, 5, 5, c), 3.0)
            jo = np.asarray(jl(jnp.asarray(x)))
            to = _nhwc(tl(_nchw(x)))
            np.testing.assert_allclose(to, jo, rtol=0, atol=QUANT_ATOL)
        _assert_state_close(tl, jl)
        JM.eval_mode(jl)
        tl.eval()
        x = _np(30, (2, 5, 5, c), 3.0)
        np.testing.assert_allclose(_nhwc(tl(_nchw(x))), np.asarray(jl(jnp.asarray(x))), rtol=0,
                                   atol=QUANT_ATOL)


@pytest.mark.parametrize("axis", [-1, 2])
def test_quant_concat_union_and_gradients_match_jax(axis):
    """``QuantConcat`` in training: the shared quantizer takes the union
    of the two side observers' ranges, both inputs fake-quantize with it;
    the output, the state and both inputs' gradients (the clip-STE, half
    on a bound) equal ``jax.grad``'s bit for bit, over two steps (the
    second backward goes through the buffers the first rebound)."""
    jl = jqat.QuantConcat(axis, cfg=JQuantConfig(a_bits=8, w_bits=8))
    tl = qat_iao.QuantConcat(axis, cfg=QuantConfig(a_bits=8, w_bits=8), device="cpu")
    _load(tl, jl)
    tl.train()
    for step in range(2):
        rng = np.random.default_rng(step)
        a = rng.standard_normal((2, 5, 4, 3)).astype(np.float32) * 2
        b = rng.standard_normal((2, 5, 4, 3)).astype(np.float32) * 0.5
        out_shape = np.asarray(JM.Concat(axis)(jnp.asarray(a), jnp.asarray(b))).shape
        r = rng.standard_normal(out_shape).astype(np.float32)
        jout = np.asarray(nnx.clone(jl)(jnp.asarray(a), jnp.asarray(b)))
        ga, gb = nnx.grad(lambda m, x, y: jnp.sum(m(x, y) * r), argnums=(1, 2))(
            jl, jnp.asarray(a), jnp.asarray(b))
        ta, tb = (_nchw(v).requires_grad_() for v in (a, b))
        tout = tl(ta, tb)
        (tout * _nchw(r)).sum().backward()
        np.testing.assert_array_equal(_nhwc(tout), jout)
        np.testing.assert_array_equal(_nhwc(ta.grad), np.asarray(ga))
        np.testing.assert_array_equal(_nhwc(tb.grad), np.asarray(gb))
        for k, v in cnn_state_from_numpy(_flat(jl), tl).items():
            assert torch.equal(tl.state_dict()[k], v), k
    aq = tl.activation_quantizer
    assert float(aq.max_val) == max(float(tl.observer_a.max_val), float(tl.observer_b.max_val))
    assert float(aq.min_val) == min(float(tl.observer_a.min_val), float(tl.observer_b.min_val))


def test_dorefa_and_wbwtab_conv_transpose_match_jax():
    """wbwtab ``QuantConvTranspose2d`` at W = 2 and 3 (alpha per out
    channel, dim 1 of torch's layout; the W = 2 centring over input
    channels, dim 0), its ``project_params`` and ``pre_quantize_weights``;
    DoReFa's is held in tests/test_torch_dorefa.py."""
    x = _np(8, (2, 5, 5, 6), 2.0)
    for W in (2, 3):
        jl = jwb.QuantConvTranspose2d(6, 8, 4, stride=2, padding=1, groups=2,
                                      cfg=JQuantConfig(W=W), rngs=nnx.Rngs(W))
        tl = qat_wbwtab.QuantConvTranspose2d(6, 8, 4, stride=2, padding=1, groups=2,
                                             cfg=QuantConfig(W=W), device="cpu")
        _load(tl, jl)
        with torch.no_grad():
            np.testing.assert_allclose(_nhwc(tl(_nchw(x))), np.asarray(jl(jnp.asarray(x))),
                                       rtol=0, atol=FLOAT_ATOL)
        jseq, tseq = JM.Sequential(jl), TM.Sequential(tl)
        jwb.project_params(jseq)
        qat_wbwtab.project_params(tseq)
        np.testing.assert_allclose(tl.weight.detach().numpy(),
                                   np.asarray(jl.weight[...]).transpose(2, 3, 0, 1), rtol=0,
                                   atol=1e-7)
        jpre_quantize(jseq)
        pre_quantize_weights(tseq)
        np.testing.assert_allclose(tl.weight.detach().numpy(),
                                   np.asarray(jl.weight[...]).transpose(2, 3, 0, 1), rtol=0,
                                   atol=1e-6)
        # W = 3: ternary codes times one alpha per out channel
        if W == 3:
            w = tl.weight.detach()
            alpha = w.abs().amax(dim=(0, 2, 3))
            assert torch.equal(w.abs() / alpha[None, :, None, None] > 0.5,
                               w != 0)


# ---------------------------------------------------------------- prepare


class JZoo(JM.OrderedModule):
    """Every new layer in one net: a conv + BN stem, a stride-2 transposed
    conv (in == out / groups), LeakyReLU, two branches (a strided conv and
    a max-pool) into a concat over channels, Sigmoid, a 1x1 head, an
    average pool and a linear classifier."""

    def __init__(self, *, rngs):
        self.stem = JM.Conv2d(3, 8, 3, padding=1, rngs=rngs)
        self.bn = JM.BatchNorm2d(8)
        self.relu = JM.ReLU()
        self.up = JM.ConvTranspose2d(8, 8, 4, stride=2, padding=1, rngs=rngs)
        self.leaky = JM.LeakyReLU(0.1)
        self.a = JM.Conv2d(8, 8, 3, stride=2, padding=1, rngs=rngs)
        self.pool = JM.MaxPool2d(2, 2)
        self.cat = JM.Concat(-1)
        self.sig = JM.Sigmoid()
        self.head = JM.Conv2d(16, 4, 1, rngs=rngs)
        self.gap = JM.AdaptiveAvgPool2d(1)
        self.flat = JM.Flatten()
        self.fc = JM.Linear(4, 10, rngs=rngs)

    def __call__(self, x):
        h = self.leaky(self.up(self.relu(self.bn(self.stem(x)))))
        h = self.sig(self.cat(self.a(h), self.pool(h)))
        return self.fc(self.flat(self.gap(self.head(h))))


class TZoo(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = TM.Conv2d(3, 8, 3, padding=1, device="cpu")
        self.bn = TM.BatchNorm2d(8, device="cpu")
        self.relu = TM.ReLU()
        self.up = TM.ConvTranspose2d(8, 8, 4, stride=2, padding=1, device="cpu")
        self.leaky = TM.LeakyReLU(0.1)
        self.a = TM.Conv2d(8, 8, 3, stride=2, padding=1, device="cpu")
        self.pool = TM.MaxPool2d(2, 2)
        self.cat = TM.Concat(-1)
        self.sig = TM.Sigmoid()
        self.head = TM.Conv2d(16, 4, 1, device="cpu")
        self.gap = TM.AdaptiveAvgPool2d(1)
        self.flat = TM.Flatten()
        self.fc = TM.Linear(4, 10, device="cpu")

    def forward(self, x):
        h = self.leaky(self.up(self.relu(self.bn(self.stem(x.permute(0, 3, 1, 2))))))
        h = self.sig(self.cat(self.a(h), self.pool(h)))
        return self.fc(self.flat(self.gap(self.head(h))))


# the JAX package's float net, its state carried into the port's
def _zoo_pair():
    jm = JZoo(rngs=nnx.Rngs(0))
    tm = TZoo()
    _load(tm, jm)
    return jm, tm


@pytest.mark.parametrize("method,kw", [
    ("iao", dict(a_bits=4, w_bits=4, first_layer_a_bits=8, first_layer_w_bits=8,
                 last_layer_a_bits=6, last_layer_w_bits=6, bn_fuse=True)),
    ("iao", dict(a_bits=8, w_bits=8, q_type=1)),
    ("dorefa", dict(a_bits=4, w_bits=4)),
    ("wbwtab", dict(W=3, A=2)),
])
def test_prepare_matches_jax(method, kw):
    """``prepare`` builds JAX's tree: the same layer type at every path,
    the same variables equal bit for bit, the same bits at every
    quantizer. The transposed conv counts as a layer in each method's
    rule: IAO's first/last overrides land on the stem and the fc, DoReFa
    skips only the stem, wbwtab skips the stem and the head."""
    jm, tm = _zoo_pair()
    jq = jprepare(jm, JQuantConfig(**kw), method=method)
    tq = prepare(tm, QuantConfig(**kw), method=method, device="cpu")
    jtypes = {".".join(map(str, p)): type(m).__name__ for p, m in nnx.iter_modules(jq) if p}
    ttypes = {n: type(m).__name__ for n, m in tq.named_modules() if n}
    for name, t in ttypes.items():
        if name in jtypes:
            assert t == jtypes[name], name
    assert {n for n in jtypes if n.count(".") == 0} == {n for n in ttypes if "." not in n}
    ref = cnn_state_from_numpy(_flat(jq), tq)
    got = tq.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    bits = {n: m.bits for n, m in tq.named_modules() if isinstance(m, qat_iao.FakeQuantizer)}
    jbits = {".".join(map(str, p)): m.bits for p, m in nnx.iter_modules(jq)
             if isinstance(m, jqat.FakeQuantizer)}
    assert bits == jbits
    quant = {"iao": "QuantConvTranspose2d", "dorefa": "QuantConvTranspose2d",
             "wbwtab": "QuantConvTranspose2d"}[method]
    assert ttypes["up"] == quant
    if method == "iao" and "first_layer_a_bits" in kw:
        assert bits["stem.weight_quantizer"] == 8 and bits["fc.weight_quantizer"] == 6
        # with BN folding only the stem (followed by its BN) of the convs
        # quantizes: three quantizable layers, the transposed conv between
        assert bits["up.weight_quantizer"] == 4 and ttypes["head"] == "Conv2d"
        assert ttypes["cat"] == "QuantConcat" and ttypes["leaky"] == "QuantLeakyReLU"
        assert ttypes["sig"] == "QuantSigmoid"
    if method == "dorefa":
        assert ttypes["stem"] == "Conv2d" and ttypes["fc"] == "QuantLinear"
    if method == "wbwtab":
        assert (ttypes["stem"], ttypes["a"], ttypes["head"]) == ("Conv2d", "QuantConv2d",
                                                                 "Conv2d")
    x = _np(9, (2, 8, 8, 3))
    with torch.no_grad():
        np.testing.assert_allclose(tq(torch.from_numpy(x)).numpy(),
                                   np.asarray(jq(jnp.asarray(x))), rtol=0, atol=QUANT_ATOL)


def test_kl_calibration_refreshes_concat_union():
    """Under KL PTQ a ``QuantConcat``'s side observers stream; its shared
    scale is the union of their resolved thresholds."""
    from micronet_tpu_torch.quant import calibrate as tcal

    cfg = QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl")
    q = train_mode(prepare(TZoo(), cfg, device="cpu"))
    with torch.no_grad():
        for i in range(2):
            q(torch.from_numpy(_np(70 + i, (2, 8, 8, 3))))
    table = tcal.finalize_entropy_calibration(q)
    aq = q.cat.activation_quantizer
    assert not hasattr(aq, "ent_counts") and q.cat.observer_a.observer == "entropy"
    want = max(table["cat/observer_a"], table["cat/observer_b"])
    assert float(aq.max_val) == np.float32(want) and bool(aq.initialized)
    assert float(aq.scale) == pytest.approx(want / 127.5, rel=1e-6)


@pytest.fixture(scope="module")
def zoo_flow():
    jm, tm = _zoo_pair()
    # W8A8, q_type 0, the BN left float: every conv quantizes, and the
    # strided conv and the max-pool chain into the concat
    return Flow(jm, tm, dict(a_bits=8, w_bits=8), (2, 8, 8, 3),
                state_rtol=STATE_RTOL)


@pytest.mark.parametrize("check", CHECKS, ids=lambda c: c.__name__)
def test_zoo_engine_stage_matches_jax(zoo_flow, check):
    check(zoo_flow)


def test_zoo_engine_layers(zoo_flow):
    """The frozen net: an ``IntConvTranspose2d`` and an ``IntConcat`` (the
    strided conv and the max-pool chained into it; the head into the
    average pool), the LeakyReLU and Sigmoid left fake-quant (opaque nodes
    to the planner)."""
    eng = zoo_flow.teng
    assert isinstance(eng.up, IntConvTranspose2d) and isinstance(eng.cat, IntConcat)
    assert isinstance(eng.leaky, qat_iao.QuantLeakyReLU)
    assert isinstance(eng.sig, qat_iao.QuantSigmoid)
    chained = sorted(n for n, m in eng.named_modules() if getattr(m, "chained", False))
    assert chained == ["a", "head", "pool"]
    np.testing.assert_allclose(run(eng, _x(7, (4, 8, 8, 3))),
                               run(zoo_flow.tfused, _x(7, (4, 8, 8, 3))), rtol=0,
                               atol=QUANT_ATOL)
