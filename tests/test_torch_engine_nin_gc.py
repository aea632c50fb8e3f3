"""The IAO engine path of the port against the JAX package on a small
NIN-GC (``cfg=[64] * 8``, W4A4 with fused BN: grouped convs, channel
shuffles, nibble-packed W4 weights, a 1x1-conv classifier) at
2 x 32 x 32. The stage-by-stage checks live in ``_torch_engine_flow.py``.
"""

import pytest
import torch
from flax import nnx

from _torch_engine_flow import CHECKS, Flow
from micronet_tpu.models import nin_gc as jnin
from micronet_tpu_torch.infer.engine import IntConv2d, IntLinear
from micronet_tpu_torch.models import nin_gc as tnin


@pytest.fixture(scope="module")
def flow():
    # calibrated state within 1e-5 (measured: 1.4e-6 at most on values of
    # size up to ~1; sums in another f32 order, no code moved)
    return Flow(jnin.Net(cfg=[64] * 8, rngs=nnx.Rngs(0)), tnin.Net(cfg=[64] * 8, device="cpu"),
                dict(a_bits=4, w_bits=4, bn_fuse=True), (2, 32, 32, 3), state_rtol=1e-5)


@pytest.mark.parametrize("check", CHECKS, ids=lambda c: c.__name__)
def test_nin_gc_stage_matches_jax(flow, check):
    check(flow)


def test_nin_gc_w4_packed_and_no_k1_layer(flow):
    """Every W4 conv with an even contraction dim stores nibble-packed
    codes; the classifier is a 1x1 conv, so the engine never reaches K1."""
    convs = [m for m in flow.teng.modules() if isinstance(m, IntConv2d)]
    assert convs and all(m.w_packed for m in convs
                         if m.w_shape[1] * m.w_shape[2] * m.w_shape[3] % 2 == 0)
    assert not any(isinstance(m, IntLinear) for m in flow.teng.modules())
    assert flow.launches == 0


def test_leaf_order_planner_matches_jax(flow):
    """Without an example input both packages chain along definition order
    (NIN-GC is a single path); the chained sets are the same."""
    from micronet_tpu.infer import freeze_int as jfreeze
    from micronet_tpu_torch.infer import freeze_int

    jeng = jfreeze(flow.jfused)
    teng = freeze_int(flow.tfused, device="cpu")
    ref = sorted(".".join(map(str, p)) for p, m in nnx.iter_modules(jeng)
                 if getattr(m, "chained", False))
    got = sorted(n for n, m in teng.named_modules() if getattr(m, "chained", False))
    assert got == ref and got


def test_prepare_without_bn_fuse_with_layer_bit_overrides():
    """``prepare`` without BN fusion (QuantConv2d + a plain BatchNorm2d)
    and with first/last-layer bit overrides builds the JAX tree: the same
    variable names and values, the same bits at every quantizer."""
    from micronet_tpu.nn import prepare as jprepare
    from micronet_tpu.nn import qat_iao as jqat
    from micronet_tpu.quant.config import QuantConfig as JQuantConfig
    from micronet_tpu_torch.interop import cnn_state_from_numpy
    from micronet_tpu_torch.nn import prepare
    from micronet_tpu_torch.nn import qat_iao as tqat
    from micronet_tpu_torch.quant.config import QuantConfig

    kw = dict(a_bits=4, w_bits=4, first_layer_a_bits=8, first_layer_w_bits=8,
              last_layer_w_bits=6)
    jq = jprepare(jnin.Net(cfg=[32] * 8, rngs=nnx.Rngs(0)), JQuantConfig(**kw))
    tnet = tnin.Net(cfg=[32] * 8, device="cpu")
    flat = {p: v[...] for p, v in nnx.state(jnin.Net(cfg=[32] * 8, rngs=nnx.Rngs(0)))
            .flat_state()}
    tnet.load_state_dict(cnn_state_from_numpy(flat))
    tq = prepare(tnet, QuantConfig(**kw), device="cpu")
    ref = cnn_state_from_numpy({p: v[...] for p, v in nnx.state(jq).flat_state()})
    got = tq.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    jbits = {".".join(map(str, p)): m.bits for p, m in nnx.iter_modules(jq)
             if isinstance(m, jqat.FakeQuantizer)}
    tbits = {n: m.bits for n, m in tq.named_modules() if isinstance(m, tqat.FakeQuantizer)}
    assert tbits == jbits
    assert tbits["model.layers.0.conv.weight_quantizer"] == 8
    assert tbits["model.layers.10.conv.weight_quantizer"] == 6
