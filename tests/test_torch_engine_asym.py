"""The asymmetric (``q_type=1``) integer engine, ``IntConvTranspose2d`` and
``IntConcat`` of the port against the JAX package's engine.

Layers: each JAX engine layer is built from random codes, scales and zero
points; its state moves to the port layer through ``cnn_state_from_numpy``
(strict), and both run the same input. The integer accumulators are exact
in both packages and the f32 correction terms and epilogue are the same
operations in the same order, so every output is held bit for bit.

Nets: the JAX engine matrix's models (``tests/test_engine_matrix.py``:
MLP, UpNet, ConvMLP, the conv-pool-conv-linear net at A4 and A2) and the
concat net of ``tests/test_engine_dataflow.py`` go stage by stage through
``_torch_engine_flow.Flow``; then each engine layer is fed JAX's input to
it and held to JAX's output bit for bit, except a symmetric first layer
(an f32 convolution of dequantized values, its sums in another order),
held within 1e-6 x max|JAX|.

The card's forms (im2col + ``torch._int_mm``, the window sums from the
patch matrix, the transposed conv as a convolution of the dilated and
padded input) run on CPU tensors here and equal the f64 route bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_engine_flow import (CHECKS, Flow, check_chained_layers, _flat, run)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu.infer import engine as je
from micronet_tpu.nn import modules as JM
from micronet_tpu_torch.infer import engine as te
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.nn import modules as TM

# ---------------------------------------------------------------- layers


def _rng(seed):
    return np.random.default_rng(seed)


def _codes(rng, lo, hi, shape):
    return rng.integers(lo, hi + 1, shape).astype(np.int8)


def _load(tlayer, jlayer):
    keys = tlayer.load_state_dict(cnn_state_from_numpy(_flat(jlayer), tlayer))
    assert not keys.missing_keys and not keys.unexpected_keys


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _act_range(bits, asym):
    return (0.0, float(2 ** bits - 1)) if asym else (-float(2 ** (bits - 1)),
                                                      float(2 ** (bits - 1) - 1))


def _x_for(rng, shape, s_x, zp, bits):
    """Inputs that reach both ends of the code range: q0 = 0 and q0 =
    2^b - 1 (stored 127 at 8 bits) both occur."""
    span = (2 ** bits) * s_x
    return (rng.uniform(-0.2, 1.2, shape) * span + zp * s_x).astype(np.float32)


# (cin, cout, k, stride, padding, dilation, groups, w_bits, a_bits):
# NIN-GC's image stem (5 x 5, 3 channels, A8/W8), a grouped 3 x 3, a
# strided and padded ResNet-like conv at W4A4, a grouped 1x1, a dilated one
CONV_CASES = [
    (3, 16, 5, 1, 2, 1, 1, 8, 8),
    (16, 32, 3, 1, 1, 1, 4, 4, 4),
    (8, 16, 3, 2, 1, 1, 1, 4, 4),
    (32, 16, 1, 1, 0, 1, 8, 4, 4),
    (12, 8, 3, 1, 2, 2, 2, 8, 8),
]


@pytest.mark.parametrize("wsym", [False, True], ids=["w_asym", "w_sym"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_asym_int_conv_equals_jax_bit_for_bit(case, wsym):
    """Asymmetric activations with asymmetric (q_type=1) or symmetric
    weights: the codes q0 - 128, the correction terms and the epilogue."""
    cin, co, k, s, p, d, g, wb, ab = case
    rng = _rng(cin * co + k)
    if wsym:
        w = _codes(rng, 1 - 2 ** (wb - 1), 2 ** (wb - 1) - 1, (k, k, cin // g, co))
    else:
        w = _codes(rng, -128, 2 ** wb - 2 - 128, (k, k, cin // g, co))
    s_w = rng.uniform(0.01, 0.05, co).astype(np.float32)
    s_x, zp = np.float32(0.037), np.float32(-rng.integers(0, 2 ** ab // 2))
    qmin, qmax = _act_range(ab, True)
    bias = rng.standard_normal(co).astype(np.float32)
    jl = je.IntConv2d(jnp.asarray(w), jnp.asarray(s_w), s_x, zp, jnp.asarray(bias), (s, s),
                      (p, p), (d, d), g, qmin, qmax)
    if not wsym:
        jl.w_symmetric = False
        jl.w_zp[...] = jnp.asarray(-rng.integers(0, 2 ** wb // 2, co).astype(np.float32))
    tl = te.IntConv2d(torch.zeros((co, cin // g, k, k), dtype=torch.int8), torch.ones(co),
                      1.0, torch.zeros(co), (s, s), (p, p), (d, d), g, qmin, qmax)
    tl.w_symmetric = wsym
    _load(tl, jl)
    x = _x_for(rng, (2, 9, 9, cin), s_x, zp, ab)
    ref = np.asarray(jl(jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tl(_nchw(x)))
    np.testing.assert_array_equal(got, ref)
    assert not tl.symmetric and tl.f32_dequant == (g == 1 and cin // g < 8)
    # the stored codes reach both ends: q0 = 2^b - 1 is stored 2^b - 129
    codes = te._act_codes(_nchw(x), tl.act_scale, tl.act_zero_point, qmin, qmax, False)
    assert int(codes.min()) == -128 and int(codes.max()) == 2 ** ab - 129
    # the card's route on CPU tensors: the same f32 bits
    tl.int_acc = tl._int_acc_im2col
    with torch.no_grad():
        np.testing.assert_array_equal(_nhwc(tl(_nchw(x))), ref)


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("wsym", [False, True], ids=["w_asym", "w_sym"])
def test_asym_int_linear_equals_jax_bit_for_bit(a_bits, wsym):
    """Asymmetric ``IntLinear`` (A8 and A4): the integer matmul (never K1)
    and the rank-1 corrections in JAX's order; ``_int_mm`` on CPU tensors
    gives the same bits as the f64 product."""
    rng = _rng(a_bits)
    k, n = 37, 10
    if wsym:
        w = _codes(rng, -127, 127, (k, n))
    else:
        w = _codes(rng, -128, 126, (k, n))
    s_w = rng.uniform(0.001, 0.01, n).astype(np.float32)
    s_x, zp = np.float32(0.05), np.float32(-3.0)
    qmin, qmax = _act_range(a_bits, True)
    jl = je.IntLinear(jnp.asarray(w), jnp.asarray(s_w), s_x, zp,
                      jnp.asarray(rng.standard_normal(n).astype(np.float32)), qmin, qmax)
    if not wsym:
        jl.w_symmetric = False
        jl.w_zp[...] = jnp.asarray(rng.integers(-100, 0, n).astype(np.float32))
    tl = te.IntLinear(torch.zeros((k, n), dtype=torch.int8), torch.ones(n), 1.0, 0.0,
                      torch.zeros(n), qmin, qmax)
    tl.w_symmetric = wsym
    _load(tl, jl)
    x = _x_for(rng, (6, k), s_x, zp, a_bits)
    ref = np.asarray(jl(jnp.asarray(x)))
    from micronet_tpu_torch.ops import int_matmul as tim8

    n0 = tim8.int8_matmul_dequant.launches
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tim8.int8_matmul_dequant.launches == n0
    x_q = te._act_codes(torch.from_numpy(x), tl.act_scale, tl.act_zero_point, qmin, qmax, False)
    card = te._int_mm_exact(x_q, tl.w_q.t())
    assert torch.equal(card.double(), x_q.double() @ tl.w_q.double())


# (cin, cout, k, stride, padding, output_padding, dilation, groups):
# UpNet's upsampler, output_padding 1, groups 4, dilation 2, and
# padding past d * (k - 1) (a crop)
CONVT_CASES = [
    (16, 8, 4, 2, 1, 0, 1, 1),
    (8, 6, 3, 2, 1, 1, 1, 1),
    (8, 12, 3, 2, 0, 0, 1, 4),
    (6, 4, 3, 1, 2, 0, 2, 1),
    (6, 6, 3, 2, 3, 1, 1, 2),
]


@pytest.mark.parametrize("q_type", [0, 1])
@pytest.mark.parametrize("case", CONVT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_int_conv_transpose_equals_jax_bit_for_bit(case, q_type):
    """``IntConvTranspose2d``, symmetric and asymmetric (layer-level weight
    zero point): the f64 route and the card's route on CPU tensors both
    give JAX's bits."""
    cin, co, k, s, p, op, d, g = case
    rng = _rng(cin + 7 * co + k)
    asym = q_type == 1
    lo, hi = (-128, 126) if asym else (-127, 127)
    w = _codes(rng, lo, hi, (k, k, cin, co // g))
    s_x, zp = np.float32(0.02), np.float32(-40.0 if asym else 0.0)
    qmin, qmax = _act_range(8, asym)
    jl = je.IntConvTranspose2d(jnp.asarray(w), np.float32(0.003), s_x, zp,
                               jnp.asarray(rng.standard_normal(co).astype(np.float32)),
                               (s, s), (p, p), (op, op), (d, d), g, qmin, qmax)
    if asym:
        jl.w_symmetric = False
        jl.w_zp[...] = jnp.asarray(np.float32(-77.0))
    tl = te.IntConvTranspose2d(torch.zeros((cin, co // g, k, k), dtype=torch.int8), 1.0, 1.0,
                               0.0, torch.zeros(co), (s, s), (p, p), (op, op), (d, d), g,
                               qmin, qmax)
    tl.w_symmetric = not asym
    _load(tl, jl)
    assert torch.equal(tl.w_q, torch.from_numpy(w.transpose(2, 3, 0, 1)))
    x = _x_for(rng, (2, 5, 6, cin), s_x, zp, 8) if asym else (
        rng.standard_normal((2, 5, 6, cin)).astype(np.float32) * 2)
    ref = np.asarray(jl(jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tl(_nchw(x)))
        tl.int_acc = tl._int_acc_im2col
        card = _nhwc(tl(_nchw(x)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(card, ref)


@pytest.mark.parametrize("case", CONVT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_card_conv_transpose_route_exact_on_cpu(case):
    """The card's transposed conv (zero-inserted, padded or cropped input,
    flipped kernel with in and out swapped, block-diagonal groups, one
    ``_int_mm``) and its window sums equal f64 ``conv_transpose2d``s of
    the same codes bit for bit, at full int8 range."""
    cin, co, k, s, p, op, d, g = case
    rng = _rng(case[0] * 31 + case[3])
    w = torch.from_numpy(_codes(rng, -128, 127, (cin, co // g, k, k)))
    x = torch.from_numpy(_codes(rng, -128, 127, (3, cin, 7, 5)))
    tl = te.IntConvTranspose2d(w, 1.0, 1.0, 0.0, None, (s, s), (p, p), (op, op), (d, d), g,
                               -128.0, 127.0)
    acc, sums = tl._int_acc_im2col(x, group_sums=True)
    ref = torch.nn.functional.conv_transpose2d(x.double(), w.double(), None, s, p, op, g, d)
    ones = torch.ones((cin, 1, k, k), dtype=torch.float64)
    ref_sums = torch.nn.functional.conv_transpose2d(x.double(), ones, None, s, p, op, g, d)
    assert acc.dtype == torch.int32 and torch.equal(acc.double(), ref)
    assert sums.dtype == torch.int32 and torch.equal(sums.double(), ref_sums)
    f64_acc, f64_sums = tl.int_acc(x, group_sums=True)
    assert torch.equal(f64_acc, ref) and torch.equal(f64_sums, ref_sums)


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_card_window_sums_exact_on_cpu(case):
    """The card's window sums (row sums of the patch matrix, per group) and
    ``conv(1, w)`` from one image of ones equal the f64 convolutions the
    JAX package computes them with, bit for bit."""
    cin, co, k, s, p, d, g, _, _ = case
    rng = _rng(co + k)
    w = torch.from_numpy(_codes(rng, -128, 127, (co, cin // g, k, k)))
    x = torch.from_numpy(_codes(rng, -128, 127, (2, cin, 9, 9)))
    tl = te.IntConv2d(w, torch.ones(co), 1.0, None, (s, s), (p, p), (d, d), g, 0.0, 255.0)
    ones_ker = torch.ones((g, cin // g, k, k), dtype=torch.float64)
    for inp in (x, torch.ones((1, cin, 9, 9), dtype=torch.int8)):
        acc, sums = tl._int_acc_im2col(inp, group_sums=True)
        ref = torch.nn.functional.conv2d(inp.double(), w.double(), None, s, p, d, g)
        ref_sums = torch.nn.functional.conv2d(inp.double(), ones_ker, None, s, p, d, g)
        assert torch.equal(acc.double(), ref) and torch.equal(sums.double(), ref_sums)


def test_int_concat_equals_jax_bit_for_bit():
    """``IntConcat`` on JAX's state: f32 and chained int8 inputs, the
    channel axis (NHWC -1 -> NCHW 1) and the height axis, dequantized or
    requantized."""
    rng = _rng(5)
    a = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    for axis in (-1, 1):
        for chained in (False, True):
            jl = je.IntConcat(axis, np.float32(0.02), -128.0, 127.0)
            tl = te.IntConcat(axis, torch.tensor(1.0), -128.0, 127.0)
            if chained:
                jl.chained = tl.chained = True
                jl.out_scale[...] = jnp.asarray(np.float32(0.03))
            _load(tl, jl)
            bq = rng.integers(-128, 128, b.shape).astype(np.int8)
            ref = np.asarray(jl(jnp.asarray(a), jnp.asarray(bq)))
            with torch.no_grad():
                got = _nhwc(tl(_nchw(a), _nchw(bq)))
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- nets


class JMLP(JM.OrderedModule):
    ORDER = ("fc1", "relu", "fc2")

    def __init__(self, *, rngs):
        self.fc1 = JM.Linear(12, 32, rngs=rngs)
        self.relu = JM.ReLU()
        self.fc2 = JM.Linear(32, 5, rngs=rngs)

    def __call__(self, x):
        return self.fc2(self.relu(self.fc1(x)))


class JUpNet(JM.OrderedModule):
    ORDER = ("c1", "up", "c2")

    def __init__(self, *, rngs):
        self.c1 = JM.Conv2d(6, 16, 3, padding=1, rngs=rngs)
        self.up = JM.ConvTranspose2d(16, 8, 4, stride=2, padding=1, rngs=rngs)
        self.c2 = JM.Conv2d(8, 4, 1, rngs=rngs)

    def __call__(self, x):
        return self.c2(self.up(self.c1(x)))


class JConvMLP(JM.OrderedModule):
    ORDER = ("conv", "relu", "pool", "flat", "fc")

    def __init__(self, *, rngs):
        self.conv = JM.Conv2d(3, 16, 3, padding=1, rngs=rngs)
        self.relu = JM.ReLU()
        self.pool = JM.MaxPool2d(2, 2, 0)
        self.flat = JM.Flatten()
        self.fc = JM.Linear(16 * 4 * 4, 10, rngs=rngs)

    def __call__(self, x):
        return self.fc(self.flat(self.pool(self.relu(self.conv(x)))))


class JConvMLP2(JM.OrderedModule):
    ORDER = ("conv", "relu", "pool", "c2", "flat", "fc")

    def __init__(self, *, rngs):
        self.conv = JM.Conv2d(3, 16, 3, padding=1, rngs=rngs)
        self.relu = JM.ReLU()
        self.pool = JM.MaxPool2d(2, 2, 0)
        self.c2 = JM.Conv2d(16, 8, 1, rngs=rngs)
        self.flat = JM.Flatten()
        self.fc = JM.Linear(8 * 4 * 4, 10, rngs=rngs)

    def __call__(self, x):
        return self.fc(self.flat(self.c2(self.pool(self.relu(self.conv(x))))))


class JCatNet(JM.OrderedModule):
    def __init__(self, *, rngs):
        self.c1 = JM.Conv2d(8, 16, 1, rngs=rngs)
        self.c2 = JM.Conv2d(8, 16, 1, rngs=rngs)
        self.cat = JM.Concat(axis=-1)
        self.c3 = JM.Conv2d(32, 8, 1, rngs=rngs)

    def __call__(self, x):
        return self.c3(self.cat(self.c1(x), self.c2(x)))


class _TNet(torch.nn.Module):
    """A port twin: NHWC in and out, as the JAX net."""

    def forward(self, x):
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        for name in self.ORDER:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


class TMLP(_TNet):
    ORDER = JMLP.ORDER

    def __init__(self):
        super().__init__()
        self.fc1 = TM.Linear(12, 32, device="cpu")
        self.relu = TM.ReLU()
        self.fc2 = TM.Linear(32, 5, device="cpu")


class TUpNet(_TNet):
    ORDER = JUpNet.ORDER

    def __init__(self):
        super().__init__()
        self.c1 = TM.Conv2d(6, 16, 3, padding=1, device="cpu")
        self.up = TM.ConvTranspose2d(16, 8, 4, stride=2, padding=1, device="cpu")
        self.c2 = TM.Conv2d(8, 4, 1, device="cpu")


class TConvMLP(_TNet):
    ORDER = JConvMLP.ORDER

    def __init__(self):
        super().__init__()
        self.conv = TM.Conv2d(3, 16, 3, padding=1, device="cpu")
        self.relu = TM.ReLU()
        self.pool = TM.MaxPool2d(2, 2, 0)
        self.flat = TM.Flatten()
        self.fc = TM.Linear(16 * 4 * 4, 10, device="cpu")


class TConvMLP2(_TNet):
    ORDER = JConvMLP2.ORDER

    def __init__(self):
        super().__init__()
        self.conv = TM.Conv2d(3, 16, 3, padding=1, device="cpu")
        self.relu = TM.ReLU()
        self.pool = TM.MaxPool2d(2, 2, 0)
        self.c2 = TM.Conv2d(16, 8, 1, device="cpu")
        self.flat = TM.Flatten()
        self.fc = TM.Linear(8 * 4 * 4, 10, device="cpu")


class TCatNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = TM.Conv2d(8, 16, 1, device="cpu")
        self.c2 = TM.Conv2d(8, 16, 1, device="cpu")
        self.cat = TM.Concat(axis=-1)
        self.c3 = TM.Conv2d(32, 8, 1, device="cpu")

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        return self.c3(self.cat(self.c1(x), self.c2(x))).permute(0, 2, 3, 1)


# (id, JAX net, port net, q_type, bits, input shape): the JAX engine
# matrix's cases at their bits; the A4 cases see inputs past the observed
# range (the JAX tests scale theirs by 3 and 2), as Flow's Gaussians at
# unit scale also do at these widths
NETS = [
    ("mlp_q1", JMLP, TMLP, 1, 8, (4, 12)),
    ("upnet_q0", JUpNet, TUpNet, 0, 8, (2, 8, 8, 6)),
    ("upnet_q1", JUpNet, TUpNet, 1, 8, (2, 8, 8, 6)),
    ("convmlp_q1", JConvMLP, TConvMLP, 1, 8, (4, 8, 8, 3)),
    ("mlp_a4_q1", JMLP, TMLP, 1, 4, (4, 12)),
    ("convmlp2_a4_q0", JConvMLP2, TConvMLP2, 0, 4, (4, 8, 8, 3)),
    ("convmlp2_a4_q1", JConvMLP2, TConvMLP2, 1, 4, (4, 8, 8, 3)),
    ("convmlp2_a2_q0", JConvMLP2, TConvMLP2, 0, 2, (4, 8, 8, 3)),
]


@pytest.fixture(scope="module", params=NETS, ids=lambda n: n[0])
def net_flow(request):
    _, jcls, tcls, q_type, bits, shape = request.param
    # calibrated state within 1e-5 (no BN; observers over the same sums)
    flow = Flow(jcls(rngs=nnx.Rngs(0)), tcls(), dict(a_bits=bits, w_bits=bits, q_type=q_type),
                shape, state_rtol=1e-5)
    flow.q_type = q_type
    return flow


_NET_CHECKS = [c for c in CHECKS if c is not check_chained_layers]


@pytest.mark.parametrize("check", _NET_CHECKS, ids=lambda c: c.__name__)
def test_matrix_net_stage_matches_jax(net_flow, check):
    check(net_flow)


def test_matrix_net_layers_bit_for_bit(net_flow):
    """Each engine layer, fed JAX's input to it, gives JAX's output bit for
    bit (int8 codes where chained); a symmetric first layer (f32 conv of
    dequantized values) within 1e-6 x max|JAX|. The chains are JAX's, and
    an asymmetric engine has none."""
    got = sorted(n for n, m in net_flow.teng.named_modules() if getattr(m, "chained", False))
    ref = sorted(".".join(map(str, p)) for p, m in nnx.iter_modules(net_flow.jeng)
                 if getattr(m, "chained", False))
    assert got == ref and (not got if net_flow.q_type else True)
    h = jnp.asarray(net_flow.x)
    for name in type(net_flow.teng).ORDER:
        jl, tl = getattr(net_flow.jeng, name), getattr(net_flow.teng, name)
        h_t = _nchw(np.asarray(h)) if h.ndim == 4 else torch.from_numpy(np.asarray(h))
        out = jl(h)
        with torch.no_grad():
            got = tl(h_t)
        got = _nhwc(got) if got.dim() == 4 else got.numpy()
        ref = np.asarray(out)
        assert got.dtype == ref.dtype, name
        if (isinstance(tl, te.IntConv2d) and tl.f32_dequant and tl.symmetric
                and not tl.chained):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=name)
            out = jnp.asarray(got)  # both go on from the same values
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        h = out


def test_concat_net_planner_and_engine_match_jax():
    """The concat net (symmetric W8A8): ``prepare`` gives ``QuantConcat``,
    calibration and the frozen engine match JAX stage by stage, and the
    planner chains c1 and c2 into the concat and the concat into c3 (three
    chained modules), as JAX's does; the engine equals JAX's bit for
    bit."""
    flow = Flow(JCatNet(rngs=nnx.Rngs(0)), TCatNet(), dict(a_bits=8, w_bits=8), (4, 8, 8, 8),
                state_rtol=1e-5)
    for check in CHECKS:
        check(flow)
    chained = sorted(n for n, m in flow.teng.named_modules() if getattr(m, "chained", False))
    assert chained == ["c1", "c2", "cat"]
    assert isinstance(flow.teng.cat, te.IntConcat) and flow.teng.cat.axis == -1
    np.testing.assert_array_equal(flow.teng_out, flow.jeng_out)
    # without an example input the leaf-order planner leaves a concat graph
    # unchained, as JAX's does
    from micronet_tpu_torch.infer import freeze_int

    eng = freeze_int(flow.tfused, device="cpu")
    assert not any(getattr(m, "chained", False) for m in eng.modules())
    np.testing.assert_allclose(run(eng, flow.x), flow.teng_out, rtol=0, atol=1e-5)
