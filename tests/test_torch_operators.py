"""The engine's two seams: the hand-written operators that ``ops/_build.py``
defines in one place, and the int8 chain protocol of ``infer/engine.py``.

CPU cases: each of the six operators keeps its schema (so an exported
``.pt2`` program still loads), gives its twin's bytes on CPU tensors and
counts no launch there, and its fake implementation gives the twin's
shape and dtype under ``FakeTensorMode``; every layer that takes chained
codes gives, for an f32 input at rounding edges and past both clips, the
output it gives for the codes ``_act_codes`` makes of it; the engines of
NIN-GC, ResNet-18 and MobileNetV2 keep their ``state_dict`` keys. Card
cases (marked ``cuda``; they skip without a card) count one launch an
eager call and none a CUDA graph replay.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from micronet_tpu_torch.infer import engine as E
from micronet_tpu_torch.ops import _build
from micronet_tpu_torch.ops import dwconv as D
from micronet_tpu_torch.ops import int_matmul as I
from micronet_tpu_torch.ops import patch_gather as PG
from micronet_tpu_torch.ops import requant_epilogue as R

# the six schemas as the operators were first defined
SCHEMAS = {
    "int8_matmul_dequant": "int8_matmul_dequant(Tensor x, Tensor w_q, Tensor w_scale, "
                           "Tensor x_scale, Tensor x_zero_point, float qmin, float qmax) -> Tensor",
    "binary_act_matmul": "binary_act_matmul(Tensor x, Tensor w_q, Tensor w_scale) -> Tensor",
    "requant_epilogue": "requant_epilogue(Tensor acc, Tensor s_x, Tensor? w_scale, Tensor? bias, "
                        "Tensor out_scale, float qmin, float qmax, bool chained) -> Tensor",
    "dwconv_int8": "dwconv_int8(Tensor x, Tensor w, Tensor s_x, Tensor w_scale, Tensor? bias, "
                   "Tensor out_scale, int[] stride, int[] padding, float qmin, float qmax, "
                   "bool chained) -> Tensor",
    "patch_matrix": "patch_matrix(Tensor x, int[] kernel, int[] stride, int[] padding, "
                    "int[] dilation, Tensor? scale) -> Tensor",
    "patch_shuffle": "patch_shuffle(Tensor x, int groups) -> Tensor",
}

# each operator's public wrapper (its launch counter) and its twin, laid out as the operator
# returns it
WRAPPERS = {"int8_matmul_dequant": I.int8_matmul_dequant,
            "binary_act_matmul": I.binary_act_matmul,
            "requant_epilogue": R.requant_epilogue, "dwconv_int8": D.dwconv_int8,
            "patch_matrix": PG.patch_matrix, "patch_shuffle": PG.patch_shuffle}
TWINS = {"int8_matmul_dequant": I.int8_matmul_dequant_ref,
         "binary_act_matmul": I.binary_act_matmul_ref,
         "requant_epilogue": R.requant_epilogue_ref, "dwconv_int8": D.dwconv_int8_ref,
         "patch_matrix": PG.patch_matrix_ref,
         "patch_shuffle": lambda x, g: PG.patch_shuffle_ref(x, g).permute(0, 2, 3, 1)}


def _codes(shape, gen, dev) -> torch.Tensor:
    """int8 codes (N, C, H, W), an NCHW view of NHWC memory as the engine
    hands them on."""
    n, c, h, w = shape
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8, generator=gen)
    return x.to(dev).permute(0, 3, 1, 2)


def _args(name: str, dev="cpu") -> list:
    """The operator's arguments in its schema's order, small, from a seed."""
    gen = torch.Generator().manual_seed(len(name))

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def rand(*shape):
        return (torch.rand(shape, generator=gen) * 0.05 + 0.01).to(dev)

    if name == "int8_matmul_dequant":
        x = (torch.randn((6, 40), generator=gen) * 2).to(dev)
        w = torch.randint(-127, 128, (40, 12), dtype=torch.int8, generator=gen).to(dev)
        return [x, w, rand(12), scalar(0.03), scalar(0.0), -8.0, 7.0]
    if name == "binary_act_matmul":
        x = torch.randn((6, 40), generator=gen).to(dev)
        w = torch.randint(-1, 2, (40, 12), dtype=torch.int8, generator=gen).to(dev)
        return [x, w, rand(12)]
    if name == "requant_epilogue":
        acc = torch.randint(-2**14, 2**14, (40, 12), dtype=torch.int32, generator=gen).to(dev)
        return [acc, scalar(0.02), rand(12), rand(12), scalar(0.1), -128.0, 127.0, True]
    if name == "dwconv_int8":
        w = D.dw_weight(torch.randint(-127, 128, (8, 1, 3, 3), dtype=torch.int8, generator=gen))
        return [_codes((2, 8, 6, 6), gen, dev), w.to(dev), scalar(0.02), rand(8), rand(8),
                scalar(0.1), [2, 2], [1, 1], -128.0, 127.0, True]
    if name == "patch_matrix":
        return [_codes((2, 8, 6, 6), gen, dev), [3, 3], [1, 1], [1, 1], [1, 1], None]
    return [_codes((2, 8, 5, 5), gen, dev), 2]


def _op(name: str):
    return getattr(torch.ops.micronet_tpu_torch, name).default


def _same_bytes(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8))


def test_one_library_defines_the_six_operators():
    """``_build.operator`` defines every operator on its one library, the
    package's only ``torch.library.Library``."""
    from pathlib import Path

    assert _build._LIB._op_defs == {f"micronet_tpu_torch::{n}" for n in SCHEMAS}
    package = Path(_build.__file__).resolve().parents[1]
    found = [p for p in package.rglob("*.py") for line in p.read_text().splitlines()
             if "torch.library.Library(" in line]
    assert found == [Path(_build.__file__).resolve()]


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_schema_is_unchanged(name):
    assert str(_op(name)._schema) == f"micronet_tpu_torch::{SCHEMAS[name]}"


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_cpu_call_is_the_twin_and_counts_no_launch(name):
    args = _args(name)
    wrapper = WRAPPERS[name]
    before = wrapper.launches
    got = _op(name)(*args)
    assert wrapper.launches == before
    _same_bytes(got, TWINS[name](*args))
    assert got.is_contiguous()


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_fake_gives_the_twins_shape_and_dtype(name):
    args = _args(name)
    want = TWINS[name](*args)
    mode = FakeTensorMode()
    fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode:
        got = _op(name)(*fake)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCHEMAS))
def test_card_counts_a_launch_an_eager_call_and_none_a_replay(card, name):
    """One launch counted for each eager call (the capture's too), none for
    a replay of the captured graph; the card's bytes are the twin's."""
    args = _args(name, card)
    wrapper, op = WRAPPERS[name], _op(name)
    before = wrapper.launches
    eager = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op(*args)
    assert wrapper.launches == before + 3
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 3
    want = TWINS[name](*[a.cpu() if isinstance(a, torch.Tensor) else a for a in _args(name)])
    _same_bytes(eager.cpu(), want)
    _same_bytes(out.cpu(), want)


# ------------------------------------------------------------ the int8 chain

_S = 0.05


def _edges(qmin: float, qmax: float) -> torch.Tensor:
    """(N, 8, 4, 4) f32 at every code's rounding edge ``(k + 0.5) * s``,
    one float either side of it, zero, and past both clips."""
    s = torch.tensor(_S)
    edges = (torch.arange(qmin - 3, qmax + 3, dtype=torch.float32) + 0.5) * s
    v = torch.cat([edges, torch.nextafter(edges, torch.tensor(-1e9)),
                   torch.nextafter(edges, torch.tensor(1e9)),
                   torch.tensor([0.0, -0.0, 1e3, -1e3, (qmax + 0.5) * _S, (qmin - 0.5) * _S])])
    per = 8 * 4 * 4
    n = -(-v.numel() // per)
    fill = torch.randn(n * per - v.numel(), generator=torch.Generator().manual_seed(0)) * 2
    return torch.cat([v, fill])[torch.randperm(n * per, generator=torch.Generator()
                                                .manual_seed(1))].reshape(n, 8, 4, 4)


def _layer(kind: str, qmin: float, qmax: float):
    gen = torch.Generator().manual_seed(2)
    s = torch.tensor(_S)
    if kind in ("conv", "depthwise"):
        co, cg, groups = (4, 8, 1) if kind == "conv" else (8, 1, 8)
        w = torch.randint(-127, 128, (co, cg, 3, 3), dtype=torch.int8, generator=gen)
        conv = E.IntConv2d(w, torch.rand(co, generator=gen) * 0.01 + 1e-3, s,
                           torch.randn(co, generator=gen) * 0.1, (1, 1), (1, 1), (1, 1), groups,
                           qmin, qmax)
        assert conv.depthwise == (kind == "depthwise") and not conv.f32_dequant
        return conv
    if kind == "maxpool":
        return E.IntMaxPool2d(2, 2, 0, s, qmin, qmax)
    if kind == "avgpool":
        return E.IntAvgPool2d(2, 2, 0, s, qmin, qmax)
    if kind == "add":
        return E.IntAdd(s, qmin, qmax)
    return E.IntConcat(-1, s, qmin, qmax)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind,chained", [
    (kind, chained) for kind in ("conv", "depthwise", "maxpool", "avgpool", "add", "concat")
    for chained in (False, True) if not (chained and kind == "avgpool")])
def test_f32_input_equals_its_act_codes(kind, chained, bits):
    """A receiver given f32 gives the output it gives for the codes
    ``_act_codes`` makes of that input at its scale and clip range,
    chained (an emitter's int8 out) or not (f32 out; an average pool emits
    no chain)."""
    qmin, qmax = (-128.0, 127.0) if bits == 8 else (-8.0, 7.0)
    layer = _layer(kind, qmin, qmax)
    if chained:
        layer.chain(torch.tensor(0.07), qmin, qmax)
    x = _edges(qmin, qmax)
    codes = E._act_codes(x, layer.act_scale, torch.zeros(()), qmin, qmax, True)
    assert int(codes.min()) == qmin and int(codes.max()) == qmax
    with torch.no_grad():
        if kind in ("add", "concat"):
            y = x.flip(0)
            y_codes = E._act_codes(y, layer.act_scale, torch.zeros(()), qmin, qmax, True)
            got, want = layer(x, y), layer(codes, y_codes)
            _same_bytes(layer(codes, y), want)
        else:
            got, want = layer(x), layer(codes)
    assert want.dtype == (torch.int8 if chained else torch.float32)
    _same_bytes(got, want)


# the engines' state_dict keys: each frozen module's prefix and the buffers of its kind
_KINDS = {"CONV": ("w_q", "w_scale", "act_scale", "act_zero_point", "w_zp", "bias", "out_scale"),
          "LINEAR": ("w_q", "w_scale", "act_scale", "act_zero_point", "w_zp", "bias"),
          "EMIT": ("act_scale", "out_scale"), "RECV": ("act_scale",)}
_STATE = {
    "nin_gc": """
        model.layers.0.conv CONV
        model.layers.1.conv CONV
        model.layers.2.conv CONV
        model.layers.3 EMIT
        model.layers.4.conv CONV
        model.layers.5.conv CONV
        model.layers.6.conv CONV
        model.layers.7 EMIT
        model.layers.8.conv CONV
        model.layers.9.conv CONV
        model.layers.10.conv CONV
        model.layers.11 RECV""",
    "resnet18": """
        conv1.layers.0 CONV
        conv2_x.layers.0.residual_function.layers.0 CONV
        conv2_x.layers.0.residual_function.layers.3 CONV
        conv2_x.layers.0.add EMIT
        conv2_x.layers.1.residual_function.layers.0 CONV
        conv2_x.layers.1.residual_function.layers.3 CONV
        conv2_x.layers.1.add EMIT
        conv3_x.layers.0.residual_function.layers.0 CONV
        conv3_x.layers.0.residual_function.layers.3 CONV
        conv3_x.layers.0.shortcut.layers.0 CONV
        conv3_x.layers.0.add EMIT
        conv3_x.layers.1.residual_function.layers.0 CONV
        conv3_x.layers.1.residual_function.layers.3 CONV
        conv3_x.layers.1.add EMIT
        conv4_x.layers.0.residual_function.layers.0 CONV
        conv4_x.layers.0.residual_function.layers.3 CONV
        conv4_x.layers.0.shortcut.layers.0 CONV
        conv4_x.layers.0.add EMIT
        conv4_x.layers.1.residual_function.layers.0 CONV
        conv4_x.layers.1.residual_function.layers.3 CONV
        conv4_x.layers.1.add EMIT
        conv5_x.layers.0.residual_function.layers.0 CONV
        conv5_x.layers.0.residual_function.layers.3 CONV
        conv5_x.layers.0.shortcut.layers.0 CONV
        conv5_x.layers.0.add EMIT
        conv5_x.layers.1.residual_function.layers.0 CONV
        conv5_x.layers.1.residual_function.layers.3 CONV
        conv5_x.layers.1.add EMIT
        avg_pool RECV
        fc LINEAR""",
    "mobilenet_v2": """
        features.layers.0.layers.0 CONV
        features.layers.1.conv.layers.0.layers.0 CONV
        features.layers.1.conv.layers.1 CONV
        features.layers.2.conv.layers.0.layers.0 CONV
        features.layers.2.conv.layers.1.layers.0 CONV
        features.layers.2.conv.layers.2 CONV
        features.layers.3.conv.layers.0.layers.0 CONV
        features.layers.3.conv.layers.1.layers.0 CONV
        features.layers.3.conv.layers.2 CONV
        features.layers.3.add EMIT
        features.layers.4.conv.layers.0.layers.0 CONV
        features.layers.4.conv.layers.1.layers.0 CONV
        features.layers.4.conv.layers.2 CONV
        features.layers.5.conv.layers.0.layers.0 CONV
        features.layers.5.conv.layers.1.layers.0 CONV
        features.layers.5.conv.layers.2 CONV
        features.layers.5.add EMIT
        features.layers.6.conv.layers.0.layers.0 CONV
        features.layers.6.conv.layers.1.layers.0 CONV
        features.layers.6.conv.layers.2 CONV
        features.layers.6.add EMIT
        features.layers.7.conv.layers.0.layers.0 CONV
        features.layers.7.conv.layers.1.layers.0 CONV
        features.layers.7.conv.layers.2 CONV
        features.layers.8.conv.layers.0.layers.0 CONV
        features.layers.8.conv.layers.1.layers.0 CONV
        features.layers.8.conv.layers.2 CONV
        features.layers.8.add EMIT
        features.layers.9.conv.layers.0.layers.0 CONV
        features.layers.9.conv.layers.1.layers.0 CONV
        features.layers.9.conv.layers.2 CONV
        features.layers.9.add EMIT
        features.layers.10.conv.layers.0.layers.0 CONV
        features.layers.10.conv.layers.1.layers.0 CONV
        features.layers.10.conv.layers.2 CONV
        features.layers.10.add EMIT
        features.layers.11.conv.layers.0.layers.0 CONV
        features.layers.11.conv.layers.1.layers.0 CONV
        features.layers.11.conv.layers.2 CONV
        features.layers.12.conv.layers.0.layers.0 CONV
        features.layers.12.conv.layers.1.layers.0 CONV
        features.layers.12.conv.layers.2 CONV
        features.layers.12.add EMIT
        features.layers.13.conv.layers.0.layers.0 CONV
        features.layers.13.conv.layers.1.layers.0 CONV
        features.layers.13.conv.layers.2 CONV
        features.layers.13.add EMIT
        features.layers.14.conv.layers.0.layers.0 CONV
        features.layers.14.conv.layers.1.layers.0 CONV
        features.layers.14.conv.layers.2 CONV
        features.layers.15.conv.layers.0.layers.0 CONV
        features.layers.15.conv.layers.1.layers.0 CONV
        features.layers.15.conv.layers.2 CONV
        features.layers.15.add EMIT
        features.layers.16.conv.layers.0.layers.0 CONV
        features.layers.16.conv.layers.1.layers.0 CONV
        features.layers.16.conv.layers.2 CONV
        features.layers.16.add EMIT
        features.layers.17.conv.layers.0.layers.0 CONV
        features.layers.17.conv.layers.1.layers.0 CONV
        features.layers.17.conv.layers.2 CONV
        features.layers.18.layers.0 CONV
        avgpool RECV
        classifier LINEAR""",
}


def _tiny_engine(name: str):
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models import mobilenet_v2, nin_gc
    from micronet_tpu_torch.models.resnet import resnet18
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = torch.Generator().manual_seed(0)
    model, bits = {
        "nin_gc": lambda: (nin_gc.Net(cfg=[32] * 8, device="cpu", generator=gen), 4),
        "resnet18": lambda: (resnet18(device="cpu", generator=gen), 8),
        "mobilenet_v2": lambda: (mobilenet_v2(device="cpu", generator=gen,
                                              widths=(16, 8, 12, 16, 24, 32, 40, 48, 64)), 8),
    }[name]()
    cfg = QuantConfig(a_bits=bits, w_bits=bits, bn_fuse=True, act_codes="off", bn_stats="off")
    q = train_mode(prepare(model, cfg, device="cpu"))
    x = torch.randn(2, 32, 32, 3, generator=gen)
    with torch.no_grad():
        q(x)
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device="cpu"))
    return freeze_int(fused, example_input=x[:1], device="cpu")


@pytest.mark.parametrize("name", list(_STATE))
def test_engine_state_dict_keys_are_unchanged(name):
    """The keys (and their order) of a tiny-width engine's state dict, as
    checkpoints, dumps and sharded state name them."""
    want = [f"{prefix}.{key}" for prefix, kind in
            (line.split() for line in _STATE[name].strip().splitlines())
            for key in _KINDS[kind]]
    assert list(_tiny_engine(name).state_dict()) == want
