"""MobileNetV2 W8A8 through the port's deploy path on the CPU: the float
model against the benchmark's plain reference (``portbench/reference/
archs/mobilenet_v2.py``), the calibrated BN-fused fake-quant model against
the reference's, the frozen engine against the fake-quant model, ReLU6
in the int8 chains, and which convs take the depthwise route. The card's
kernel is held to the block-diagonal route in
``tests/test_torch_dwconv.py``."""

import pytest
import torch

from micronet_tpu_torch.infer import engine as E
from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
from micronet_tpu_torch.models import mobilenet_v2 as factory
from micronet_tpu_torch.models.mobilenet_v2 import CIFAR_STRIDES, WIDTHS
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.nn import modules as M
from micronet_tpu_torch.ops.requant_epilogue import requant
from micronet_tpu_torch.quant.config import QuantConfig
from portbench import compare, harness, program, weights, work
from portbench.reference import arch
from portbench.reference.archs import mobilenet_v2 as ref_arch
from portbench.traffic import engine_closed, engine_closed_arch

# narrow, with the published net's residual structure (no two neighbouring widths equal)
NARROW = (16, 8, 12, 16, 24, 32, 40, 48, 64)
W8A8 = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True, act_codes="off", bn_stats="off")


def _config(widths=NARROW) -> dict:
    cfg = harness.load_json("configs", "mobilenetv2_w8a8.json")
    cfg["widths"] = list(widths)
    cfg["model"]["kwargs"] = {"widths": list(widths)}
    return cfg


@pytest.fixture(scope="module")
def calibrated():
    """The narrow net from seed weights, calibrated on 2 x 8 Gaussian
    images, BN folded; its reference logits of 8 more; the engine."""
    cfg = _config()
    ops = work.arch_ops(cfg)
    gen = weights.generator(7, "cpu")
    w = weights.make_weights(ops, gen, "cpu")
    calib = weights.gaussian_images(gen, "cpu", 2, 8)
    x = weights.gaussian_images(gen, "cpu", 8)
    q = train_mode(prepare(program.float_model(cfg, w, "cpu"), W8A8, device="cpu"))
    with torch.no_grad():
        for c in calib:
            q(c)
    fused = eval_mode(fuse_bn_iao(eval_mode(q), W8A8, device="cpu"))
    with engine_closed_arch._reference(cfg):
        ref = engine_closed.reference_logits(ops, w, calib, x[None], cfg["quant"], "exact")[0]
    eng = eval_mode(freeze_int(fused, example_input=x[:1], device="cpu"))
    return dict(cfg=cfg, ops=ops, w=w, calib=calib, x=x, fused=fused, ref=ref, engine=eng)


@pytest.mark.parametrize("widths", [WIDTHS, NARROW])
def test_state_keys_and_shapes_are_the_references(widths):
    model = factory(device="cpu", widths=widths)
    spec = arch.param_shapes(ref_arch.ops(widths=widths))
    state = model.state_dict()
    assert set(state) == set(spec)
    assert all(tuple(state[k].shape) == shape for k, (shape, _, _) in spec.items())


def test_the_published_net_and_its_cut():
    """Table 2's widths and block counts, 52 convs (17 depthwise) and the
    classifier, 87,976,448 multiply-adds an image at 32 x 32, and the
    configuration's strides are the model's and the reference's."""
    model = factory(device="cpu")
    convs = [m for m in model.modules() if isinstance(m, M.Conv2d)]
    assert len(convs) == 52 and sum(m.groups > 1 for m in convs) == 17
    assert sum(isinstance(m, M.Add) for m in model.modules()) == 10
    assert sum(isinstance(m, M.ReLU6) for m in model.modules()) == 35
    cfg = harness.load_json("configs", "mobilenetv2_w8a8.json")
    assert tuple(cfg["strides"]) == CIFAR_STRIDES == ref_arch.STRIDES
    assert tuple(cfg["widths"]) == WIDTHS == ref_arch.WIDTHS
    assert work.forward_macs(work.arch_ops(cfg)) == 87_976_448
    assert model(torch.zeros(1, 32, 32, 3)).shape == (1, 10)


def test_calibrated_fake_quant_model_is_the_references(calibrated):
    """The prepared, calibrated, BN-fused model equals the reference's
    ``Net`` to 1e-5, and ``IaoNet`` (ReLU for ReLU6, a ReLU after each
    add) does not."""
    c = calibrated
    with torch.no_grad():
        got = c["fused"](c["x"])
    assert torch.allclose(got, c["ref"], rtol=0, atol=1e-5)
    plain = engine_closed.reference_logits(c["ops"], c["w"], c["calib"], c["x"][None],
                                           c["cfg"]["quant"], "exact")[0]
    assert (plain - c["ref"]).abs().max() > 1e-3


def test_engine_against_the_fake_quant_model(calibrated):
    """The frozen engine's CPU route: with its int8 chains (ReLU6 folded
    into the emitters) the logits equal the unchained engine's bit for
    bit; against the fake-quant model they move only where a code sits on
    a rounding edge (f32 sums there, exact integers here): a mean gap
    under a tenth of the int4 control's, the same top class almost
    everywhere."""
    c = calibrated
    unchained = eval_mode(freeze_int(c["fused"], chain_int8=False, device="cpu"))
    with torch.no_grad():
        got, flat, fq = c["engine"](c["x"]), unchained(c["x"]), c["fused"](c["x"])
    assert torch.equal(got, flat)
    with engine_closed_arch._reference(c["cfg"]):
        low = engine_closed.reference_logits(c["ops"], c["w"], c["calib"], c["x"][None],
                                             {"a_bits": 4, "w_bits": 4}, "exact")
    sound = compare.engine_numbers([(0, got)], [fq])[0]
    control = compare.engine_numbers([(0, low[0])], [fq])[0]
    assert sound["logit_mean_gap"] < 0.1 * control["logit_mean_gap"]
    assert (got.argmax(1) == fq.argmax(1)).float().mean() >= 0.75


def test_engine_chains_int8_through_the_blocks(calibrated):
    """Each expansion, depthwise conv and projection emits int8 codes to
    its one receiver; a ReLU6 between them holds the code of 6; the stem
    chains into the first block; the only f32 outputs are the projections
    whose block output fans out to a residual block's conv and add, the
    adds that do the same, and the head into the pool."""
    eng = calibrated["engine"]
    blocks = list(eng.features.layers)[1:-1]
    convs = [m for m in eng.modules() if isinstance(m, E.IntConv2d)]
    adds = [m for m in eng.modules() if isinstance(m, E.IntAdd)]
    assert eng.features.layers[0].layers[0].chained
    for b in blocks:
        inner = [m for m in b.conv.modules() if isinstance(m, E.IntConv2d)]
        assert all(m.chained for m in inner[:-1])
    feeds_residual = [b.conv.layers[-2] for b, nxt in zip(blocks, blocks[1:])
                      if not b.use_res_connect and nxt.use_res_connect]
    assert {id(m) for m in convs if not m.chained} == {id(m) for m in feeds_residual}
    assert sum(a.chained for a in adds) == 5 and len(adds) == 10
    relu6 = [m for m in eng.modules() if isinstance(m, M.ReLU6)]
    assert len(relu6) == 35 and all(m.code_max == 127 for m in relu6)


def _receiver(scale: float) -> E.IntAvgPool2d:
    return E.IntAvgPool2d(2, 2, 0, torch.tensor(scale))


@pytest.mark.parametrize("observed", [True, False])
def test_relu6_passthrough_equals_quantize_after_clamp(observed):
    """An emitter chained through a ReLU6 gives the receiver's codes of the
    clamped value: for a scale observed on ReLU6 outputs (s <= 6 / 127.5,
    the code of 6 past the clamp) and for scales that are not (the code of
    6 inside the range), over values around 0, 6 and every code edge."""
    gen = torch.Generator().manual_seed(int(observed))
    scales = ([6.0 / 127.5, 5.9 / 127.5, 1e-3] if observed
              else [0.0713, 0.1, 6.0 / 7.5, 2.0 / 3.0])
    for s in scales:
        recv, emitter, relu6 = _receiver(s), E.IntMaxPool2d(2, 2, 0, torch.tensor(1.0)), M.ReLU6()
        E._link(emitter, recv, [M.Identity(), relu6])
        s32 = torch.tensor(s)
        assert relu6.code_max == min(127, int(torch.floor(6.0 / s32 + 0.5)))
        assert (emitter.out_qmin, emitter.out_qmax) == (0.0, float(relu6.code_max))
        edges = (torch.arange(-130, 131, dtype=torch.float32) + 0.5) * s32
        v = torch.cat([torch.randn(4096, generator=gen) * 4 + 3, edges,
                       torch.nextafter(edges, torch.tensor(-1e9)),
                       torch.nextafter(edges, torch.tensor(1e9)),
                       torch.tensor([0.0, -0.0, 6.0, 5.999999, 6.000001, 1e9, -1e9])])
        chained = requant(v, emitter.out_scale, emitter.out_qmin, emitter.out_qmax)
        assert torch.equal(relu6(chained), chained)
        want = E._act_codes(relu6(v), recv.act_scale, torch.zeros(()), recv.a_qmin,
                            recv.a_qmax, True)
        assert torch.equal(chained, want), s


def _frozen_convs(model, size: int):
    q = train_mode(prepare(model, W8A8, device="cpu"))
    with torch.no_grad():
        q(torch.randn(2, size, size, 3, generator=torch.Generator().manual_seed(3)))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), W8A8, device="cpu"))
    eng = freeze_int(fused, chain_int8=False, device="cpu")
    return [m for m in eng.modules() if isinstance(m, E.IntConv2d)]


def test_depthwise_dispatch():
    """The depthwise route takes MobileNetV2's 17 3 x 3 depthwise convs and
    nothing of NIN-GC (grouped convs with C_in / groups of 16 to 128) or
    the ResNets, whose convs keep the block-diagonal or dense GEMM."""
    from micronet_tpu_torch.models import nin_gc
    from micronet_tpu_torch.models.resnet import BasicBlock, BottleNeck, ResNet

    mnet = _frozen_convs(factory(device="cpu", widths=NARROW), 32)
    assert [m.depthwise for m in mnet].count(True) == 17
    assert all(m.depthwise == (m.groups > 1) for m in mnet)
    gen = torch.Generator().manual_seed(0)
    grouped = {}
    for name, model in (("nin_gc", nin_gc.Net(device="cpu", generator=gen)),
                        ("basic", ResNet(BasicBlock, [1, 1, 1, 1], device="cpu", generator=gen)),
                        ("bottleneck", ResNet(BottleNeck, [1, 1, 1, 1], device="cpu",
                                              generator=gen))):
        convs = _frozen_convs(model, 32)
        assert convs and not any(m.depthwise for m in convs)
        grouped[name] = sum(m.groups > 1 for m in convs)
    assert grouped == {"nin_gc": 7, "basic": 0, "bottleneck": 0}


@pytest.mark.parametrize("method", ["iao", "dorefa", "wbwtab"])
def test_prepare_leaves_relu6_alone(method):
    model = factory(device="cpu", widths=NARROW)
    before = [m for m in model.modules() if isinstance(m, M.ReLU6)]
    q = prepare(model, QuantConfig(), method=method, inplace=True, device="cpu")
    after = [m for m in q.modules() if isinstance(m, M.ReLU6)]
    assert after == before and len(after) == 35
