"""The asymmetric W4A4 recipe with 8-bit first and last layers
(``q_type=1``, BN folded: ACC_TABLE's ResNet-18 row of that recipe) on a
small ResNet (``ResNet(BasicBlock, [1, 1, 1, 1])``) at 2 x 16 x 16, the
port against the JAX package stage by stage (``_torch_engine_flow.py``):
strided and padded asymmetric convs, the 1x1 shortcuts, the residual
adds left fake-quant (their quantizer is asymmetric), the fc an
asymmetric ``IntLinear`` on a plain integer matmul (never K1).

Two of the shared checks do not hold here, for JAX as for the port:

- the engine against its fake-quant model (``check_engine_logits``'s
  second half): JAX's engine is 0.197 from JAX's fused model on these
  logits, and the port's engine equals JAX's bit for bit. The JAX
  package adds the correction terms in f32; at W4 the stored codes
  ``q0 - 128`` sit near -128 and a 3 x 3 x 128 window's terms reach 1e7
  and cancel, so each rounding errs by units of the accumulator.
  ``test_asym_resnet_engine_vs_exact_by_layer`` holds every layer's
  accumulator to that rounding's bound of the exact integer value
  instead;
- the calibrated state within 5e-2 (the symmetric flow's bound): at W4 a
  code that moves at a .5 edge is a sixteenth of its range, and the last
  stage's BN statistics come from 8 values a channel; measured 0.196 of
  a running variance (relative to max(1, |value|)), so 0.25 here.
"""

import numpy as np
import pytest
from flax import nnx

from _torch_engine_flow import (CHECKS, Flow, check_chained_layers, check_engine_logits,
                                run)
from micronet_tpu.models import resnet as jres
from micronet_tpu_torch.infer.engine import IntConv2d, IntLinear, exact_zero_point_acc
from micronet_tpu_torch.models import resnet as tres
from micronet_tpu_torch.nn.qat_iao import QuantAdd

ASYM_FL8 = dict(a_bits=4, w_bits=4, q_type=1, bn_fuse=True, first_layer_a_bits=8,
                first_layer_w_bits=8, last_layer_a_bits=8, last_layer_w_bits=8)


@pytest.fixture(scope="module")
def flow():
    return Flow(jres.ResNet(jres.BasicBlock, [1, 1, 1, 1], rngs=nnx.Rngs(0)),
                tres.ResNet(tres.BasicBlock, [1, 1, 1, 1], device="cpu"), ASYM_FL8,
                (2, 16, 16, 3), state_rtol=0.25)


@pytest.mark.parametrize("check", [c for c in CHECKS
                                   if c not in (check_chained_layers, check_engine_logits)],
                         ids=lambda c: c.__name__)
def test_asym_resnet_stage_matches_jax(flow, check):
    check(flow)


def test_asym_resnet_engine_layers(flow):
    """Every conv and the fc asymmetric, unpacked and unchained; the stem
    and the fc at 8 bits, the rest at 4; the adds stay fake-quant; the fc
    launches no K1 (on the CPU nothing counts either way, so the count is
    of the route: no IntLinear is symmetric)."""
    layers = [m for m in flow.teng.modules() if isinstance(m, (IntConv2d, IntLinear))]
    assert len(layers) == 13 and isinstance(flow.teng.fc, IntLinear)
    assert not any(m.symmetric or m.w_symmetric or m.w_packed or getattr(m, "chained", False)
                   for m in layers)
    assert layers[0].a_qmax == 255.0 and flow.teng.fc.a_qmax == 255.0
    assert sorted({m.a_qmax for m in layers}) == [15.0, 255.0]
    assert sum(isinstance(m, QuantAdd) for m in flow.teng.modules()) == 4
    assert flow.launches == 0
    np.testing.assert_array_equal(flow.teng_out, flow.jeng_out)


def test_asym_resnet_engine_vs_exact_by_layer(flow):
    """Each asymmetric conv's f32 accumulator with its zero-point terms,
    on the fake-quant model's input to it, lies within the rounding bound
    of the JAX package's f32 order (``exact_zero_point_acc``) of the exact
    integer value; some of them round (the gap to the fake-quant model
    is that rounding). The fc (8 bits, 512 inputs) is held to the fake-quant
    fc within 1e-5 of its output's size."""
    import torch

    from micronet_tpu_torch.infer.engine import _act_codes

    fused = dict(flow.tfused.named_modules())
    names = [n for n, m in flow.teng.named_modules() if isinstance(m, (IntConv2d, IntLinear))]
    seen = {}

    def keep(n):
        def hook(module, args, out):
            seen[n] = (args[0], out)
        return hook

    hooks = [fused[n].register_forward_hook(keep(n)) for n in names]
    run(flow.tfused, flow.x)
    for h in hooks:
        h.remove()
    rounded = 0
    with torch.no_grad():
        for n in names:
            layer, (x, ref) = flow.teng.get_submodule(n), seen[n]
            if isinstance(layer, IntLinear):
                tol = 1e-5 * ref.abs().max().item()
                assert (layer(x) - ref).abs().max().item() <= tol, n
                continue
            x_q = _act_codes(x, layer.act_scale, layer.act_zero_point, layer.a_qmin,
                             layer.a_qmax, False)
            exact, bound = exact_zero_point_acc(layer, x_q)
            err = (layer._zero_point_acc(x_q).double() - exact).abs()
            assert bool((err <= bound).all()), n
            rounded += bool(err.max() > 0)
    assert rounded
