"""The BottleNeck ResNets of the port against the JAX package.

- ``ResNet(BottleNeck, [1, 1, 1, 1])``, W8A8 with fused BN, through every
  stage of ``_torch_engine_flow.CHECKS`` at 2 x 32 x 32: 1x1 / 3x3 / 1x1
  residual branches, 1x1 projection shortcuts (stride 2 from the second
  stage on) paired with their BNs, ``QuantAdd``/``IntAdd`` at 4x
  expansion, and the fc an ``IntLinear`` at K = 2,048 (kernel K1's twin).
- Full-depth ``resnet50`` on both sides: the float forward at 2 x 32 x 32
  and the ``prepare`` counts. Its quantized forwards are left to the flow
  above (JAX's eager fake-quant ResNet-50 takes about 40 s on the CPU).
- The port's four deeper ResNets (``resnet34`` to ``resnet152``): module
  counts after ``prepare`` and one float forward each.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from _torch_engine_flow import CHECKS, FLOAT_ATOL, Flow, _flat, _x, run
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu.models import resnet as jres
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import qat_iao as jqat
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.infer.engine import IntAdd, IntLinear
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import resnet as tres
from micronet_tpu_torch.nn import eval_mode, prepare
from micronet_tpu_torch.nn.qat_iao import QuantAdd, QuantBNFuseConv2d
from micronet_tpu_torch.quant.config import QuantConfig

_CFG = dict(a_bits=8, w_bits=8, bn_fuse=True)


@pytest.fixture(scope="module")
def flow():
    # The tolerances of the BasicBlock flow (tests/test_torch_engine.py),
    # at 32 x 32 rather than its 16 x 16. Each channel's batch variance in
    # the last stage folds into the weights before their observer. At
    # 16 x 16 that stage sees 2 x 2 pixels of a batch of 2, 8 values a
    # channel, and its calibrated state is chaotic: the port against
    # itself, with the calibration inputs scaled by 1 +- 1e-7 or 3e-7,
    # moved conv5_x's 1x1 weight ranges by 0.05 to 0.12 (0.31 at 1e-6),
    # and against JAX by 0.134, the same spread. At 32 x 32 (32 values a
    # channel) the same perturbations moved the state by 0.010 to 0.028
    # (0.039 at 1e-6), inside the 5e-2 the BasicBlock flow holds.
    return Flow(jres.ResNet(jres.BottleNeck, [1, 1, 1, 1], rngs=nnx.Rngs(0)),
                tres.ResNet(tres.BottleNeck, [1, 1, 1, 1], device="cpu"),
                _CFG, (2, 32, 32, 3), state_rtol=5e-2)


@pytest.mark.parametrize("check", CHECKS, ids=lambda c: c.__name__)
def test_bottleneck_stage_matches_jax(flow, check):
    check(flow)


def test_bottleneck_prepare_pairs_every_conv_with_its_bn(flow):
    """Three fused convs a block, the four projection shortcuts and the
    stem; one ``QuantAdd`` a block, each an ``IntAdd`` in the engine."""
    assert sum(isinstance(m, QuantBNFuseConv2d) for m in flow.tq.modules()) == 3 * 4 + 4 + 1
    assert sum(isinstance(m, QuantAdd) for m in flow.tq.modules()) == 4
    assert sum(isinstance(m, IntAdd) for m in flow.teng.modules()) == 4
    shortcuts = [flow.tq.get_submodule(f"conv{i}_x.layers.0.shortcut.layers.0")
                 for i in range(2, 6)]
    assert all(isinstance(m, QuantBNFuseConv2d) and m.kernel_size == (1, 1) for m in shortcuts)
    assert [m.stride for m in shortcuts] == [(1, 1), (2, 2), (2, 2), (2, 2)]


def test_bottleneck_fc_is_the_one_k1_layer(flow):
    """The fc (2,048 -> 10) is the engine's one ``IntLinear`` (kernel K1);
    on the CPU the twin runs and nothing counts."""
    assert flow.launches == 0
    layers = [(n, m) for n, m in flow.teng.named_modules() if isinstance(m, IntLinear)]
    assert [n for n, _ in layers] == ["fc"]
    assert tuple(layers[0][1].w_q.shape) == (2048, 10)


@pytest.fixture(scope="module")
def resnet50_pair():
    jm = jres.resnet50(rngs=nnx.Rngs(0))
    tm = tres.resnet50(device="cpu")
    keys = tm.load_state_dict(cnn_state_from_numpy(_flat(jm), tm))
    assert not keys.missing_keys and not keys.unexpected_keys
    return jm, tm


def test_resnet50_float_forward_matches_jax(resnet50_pair):
    import jax.numpy as jnp

    from micronet_tpu.nn import eval_mode as jeval

    jm, tm = resnet50_pair
    x = _x(5, (2, 32, 32, 3))
    jeval(jm)
    eval_mode(tm)
    np.testing.assert_allclose(run(tm, x), np.asarray(jm(jnp.asarray(x))), rtol=0,
                               atol=FLOAT_ATOL)


def test_resnet50_prepare_counts_match_jax(resnet50_pair):
    """As ``tests/test_resnet_quant.py`` counts them: 16 adds (3 + 4 + 6 + 3
    blocks) and 53 fused convs (48 in the blocks, 4 projection shortcuts,
    the stem), on both sides."""
    jm, tm = resnet50_pair
    jq = jprepare(jm, JQuantConfig(**_CFG), method="iao")
    tq = prepare(tm, QuantConfig(**_CFG), device="cpu")
    j_counts = [sum(isinstance(m, t) for _, m in nnx.iter_modules(jq))
                for t in (jqat.QuantAdd, jqat.QuantBNFuseConv2d)]
    t_counts = [sum(isinstance(m, t) for m in tq.modules()) for t in (QuantAdd, QuantBNFuseConv2d)]
    assert t_counts == j_counts == [16, 53]


@pytest.mark.parametrize("name,adds,fused", [("resnet34", 16, 36), ("resnet50", 16, 53),
                                              ("resnet101", 33, 104), ("resnet152", 50, 155)])
def test_resnet_depth_counts_and_float_forward(name, adds, fused):
    """Each depth's blocks: 2 (BasicBlock) or 3 (BottleNeck) fused convs
    a block, one a projection shortcut, the stem; one add a block."""
    model = getattr(tres, name)(device="cpu", generator=torch.Generator().manual_seed(0))
    out = run(eval_mode(model), _x(1, (1, 32, 32, 3)))
    assert out.shape == (1, 10) and np.isfinite(out).all()
    q = prepare(model, QuantConfig(**_CFG), device="cpu")
    assert sum(isinstance(m, QuantAdd) for m in q.modules()) == adds
    assert sum(isinstance(m, QuantBNFuseConv2d) for m in q.modules()) == fused
