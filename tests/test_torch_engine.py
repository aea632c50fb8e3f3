"""The IAO engine path of the port against the JAX package on a small
ResNet (``ResNet(BasicBlock, [1, 1, 1, 1])``, W8A8 with fused BN,
residual adds through ``QuantAdd``/``IntAdd``, its fc on kernel K1) at
2 x 16 x 16. The stage-by-stage checks live in ``_torch_engine_flow.py``.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from _torch_engine_flow import CHECKS, QUANT_ATOL, Flow, _x, run
from micronet_tpu.models import resnet as jres
from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
from micronet_tpu_torch.infer.engine import IntConv2d, IntLinear
from micronet_tpu_torch.models import resnet as tres
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.nn.qat_iao import QuantAdd
from micronet_tpu_torch.quant.config import QuantConfig


@pytest.fixture(scope="module")
def flow():
    # Calibrated state within 5e-2: the last stage sees 2 x 2 pixels of a
    # batch of 2, so each channel's batch variance comes from 8 values and
    # folds into the weights before their observer. One activation code
    # that moves by a step upstream (sums in another f32 order) shifts that
    # variance, and a weight range with it, by several percent (measured:
    # 0.030 on a weight range of 0.21, 1.4e-3 on running means).
    return Flow(jres.ResNet(jres.BasicBlock, [1, 1, 1, 1], rngs=nnx.Rngs(0)),
                tres.ResNet(tres.BasicBlock, [1, 1, 1, 1], device="cpu"),
                dict(a_bits=8, w_bits=8, bn_fuse=True), (2, 16, 16, 3), state_rtol=5e-2)


@pytest.mark.parametrize("check", CHECKS, ids=lambda c: c.__name__)
def test_resnet_stage_matches_jax(flow, check):
    check(flow)


def test_resnet_fc_is_the_one_k1_layer(flow):
    """The fc is the engine's one ``IntLinear`` (kernel K1); on the CPU
    the twin runs and nothing counts."""
    assert flow.launches == 0
    assert [n for n, m in flow.teng.named_modules() if isinstance(m, IntLinear)] == ["fc"]
    assert not any(getattr(m, "w_packed", False) for m in flow.teng.modules())


def test_no_example_input_and_asymmetric_config(flow):
    """Without an example input the leaf-order planner leaves a graph with
    adds unchained, and the engine stays right. q_type=1 freezes: every
    conv and the fc asymmetric in activations and weights (never packed,
    never chained), the adds left fake-quant as in the JAX package, and
    the engine gives its fused model's logits."""
    eng = freeze_int(flow.tfused, device="cpu")
    assert not any(getattr(m, "chained", False) for m in eng.modules())
    np.testing.assert_allclose(run(eng, flow.x), flow.teng_out, rtol=0, atol=QUANT_ATOL)
    cfg = QuantConfig(q_type=1, bn_fuse=True)
    q = train_mode(prepare(flow.tfloat, cfg, device="cpu"))
    for i in range(3):
        run(q, _x(10 + i, flow.x.shape))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device="cpu"))
    asym = eval_mode(freeze_int(fused, example_input=torch.from_numpy(flow.x[:1]),
                                device="cpu"))
    layers = [m for m in asym.modules() if isinstance(m, (IntConv2d, IntLinear))]
    assert isinstance(asym.fc, IntLinear) and len(layers) == sum(
        isinstance(m, (IntConv2d, IntLinear)) for m in flow.teng.modules())
    assert not any(m.symmetric or m.w_symmetric or getattr(m, "w_packed", False)
                   for m in layers)
    assert sum(isinstance(m, QuantAdd) for m in asym.modules()) == 4
    assert not any(getattr(m, "chained", False) for m in asym.modules())
    np.testing.assert_allclose(run(asym, flow.x), run(fused, flow.x), rtol=0, atol=QUANT_ATOL)


@pytest.mark.parametrize("entry", ["model", "prepare", "fuse", "freeze"])
def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch, flow, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = QuantConfig(bn_fuse=True)
    calls = {
        "model": lambda: tres.resnet18(),
        "prepare": lambda: prepare(flow.tfloat, cfg),
        "fuse": lambda: fuse_bn_iao(flow.tq, cfg),
        "freeze": lambda: freeze_int(flow.tfused),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


# (batch, cin, size, cout, kernel, stride, padding, dilation, groups, W4):
# ResNet-18's 3x3, strided and 1x1-shortcut shapes (narrowed), its widest
# window (3 x 3 x 512), NIN-GC's grouped 3x3 and 1x1 convs with packed W4,
# its 10-way classifier (N = 10), a batch-1 call with M = 16 rows, and a
# dilated grouped conv
_IM2COL_CASES = [
    (2, 64, 8, 64, 3, 1, 1, 1, 1, False),
    (2, 64, 8, 128, 3, 2, 1, 1, 1, False),
    (2, 64, 8, 128, 1, 2, 0, 1, 1, False),
    (1, 512, 4, 512, 3, 1, 1, 1, 1, False),
    (2, 256, 8, 512, 3, 1, 1, 1, 16, True),
    (2, 64, 8, 64, 1, 1, 0, 1, 32, True),
    (2, 64, 8, 10, 1, 1, 0, 1, 1, True),
    (2, 12, 9, 20, 3, 2, 2, 2, 4, False),
]


@pytest.mark.parametrize("case", _IM2COL_CASES)
def test_card_conv_route_exact_on_cpu(case):
    """The card's integer conv route (im2col over the codes, one
    ``torch._int_mm`` over a block-diagonal weight, padded K, N and M) runs
    here on CPU tensors too: its int32 accumulator equals an f64
    convolution of the same codes bit for bit."""
    from micronet_tpu_torch.infer.engine import IntConv2d, _maybe_pack_w4

    n, cin, size, co, k, s, p, d, groups, w4 = case
    lim = 8 if w4 else 128
    rng = np.random.default_rng(cin * co + k)
    w = torch.from_numpy(rng.integers(1 - lim, lim, (co, cin // groups, k, k)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-lim, lim, (n, cin, size, size)).astype(np.int8))
    conv = IntConv2d(w, torch.ones(co), torch.tensor(1.0), None, (s, s), (p, p), (d, d),
                     groups, -lim, lim - 1)
    if w4:
        _maybe_pack_w4(conv, conv._weights_hwio().reshape(-1, co))
        assert conv.w_packed
    acc = conv._int_acc_im2col(x)
    ref = torch.nn.functional.conv2d(x.double(), w.double(), None, s, p, d, groups)
    assert acc.dtype == torch.int32 and torch.equal(acc.double(), ref)
    assert torch.equal(conv.int_acc(x), ref)  # the CPU route
