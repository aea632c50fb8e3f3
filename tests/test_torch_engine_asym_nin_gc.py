"""The asymmetric W4A4 recipe with 8-bit first and last layers
(``q_type=1``, BN folded: the ACC_TABLE row ``iao_w4a4_asym_fl8``) on a
narrow NIN-GC (``cfg=[64] * 8``) at 2 x 32 x 32, the port against the
JAX package stage by stage (``_torch_engine_flow.py``): grouped, padded
asymmetric convs with their correction terms, the first layer at A8/W8
on the integer route, the max-pools left fake-quant, no int8 chain."""

import numpy as np
import pytest
from flax import nnx

from _torch_engine_flow import CHECKS, Flow, check_chained_layers
from micronet_tpu.models import nin_gc as jnin
from micronet_tpu_torch.infer.engine import IntConv2d
from micronet_tpu_torch.models import nin_gc as tnin
from micronet_tpu_torch.nn.qat_iao import QuantMaxPool2d

ASYM_FL8 = dict(a_bits=4, w_bits=4, q_type=1, bn_fuse=True, first_layer_a_bits=8,
                first_layer_w_bits=8, last_layer_a_bits=8, last_layer_w_bits=8)


@pytest.fixture(scope="module")
def flow():
    # calibrated state within 1e-5, as the symmetric W4A4 flow of this net
    return Flow(jnin.Net(cfg=[64] * 8, rngs=nnx.Rngs(0)), tnin.Net(cfg=[64] * 8, device="cpu"),
                ASYM_FL8, (2, 32, 32, 3), state_rtol=1e-5)


@pytest.mark.parametrize("check", [c for c in CHECKS if c is not check_chained_layers],
                         ids=lambda c: c.__name__)
def test_asym_nin_gc_stage_matches_jax(flow, check):
    check(flow)


def test_asym_nin_gc_engine_layers(flow):
    """Every conv is asymmetric in activations and weights, unpacked and
    unchained; the first and last at 8 bits (codes up to 255, stored
    127), the body at 4; the max-pools stay fake-quant, as in JAX; the
    engine gives JAX's logits bit for bit (integer convs only, then the
    average pool of both packages over the same values)."""
    convs = [m for m in flow.teng.modules() if isinstance(m, IntConv2d)]
    assert len(convs) == 9
    assert not any(m.symmetric or m.w_symmetric or m.w_packed or m.chained for m in convs)
    assert [m.a_qmax for m in convs] == [255.0] + [15.0] * 7 + [255.0]
    assert sum(isinstance(m, QuantMaxPool2d) for m in flow.teng.modules()) == 2
    np.testing.assert_array_equal(flow.teng_out, flow.jeng_out)
