"""DoReFa in the port against the JAX package: the quantizers and their
gradients, the QAT layers, ``prepare(method="dorefa")`` and the
``quant_inference`` copy made by ``pre_quantize_weights``, on a small NIN
(``cfg=[8] * 8``) at batch 2.

Tolerances: DoReFa's ``tanh`` is computed by different code in XLA and in
torch, so a weight whose pre-round value sits within 1e-5 (in grid steps)
of a half step may land on the other code; codes are held equal
everywhere else. Gradients pass the round straight through, so they
hold within 1e-5 x max|g| everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.infer.bn_fuse import pre_quantize_weights as pre_quantize_weights_j
from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import qat_dorefa as jqd
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant import dorefa as jdf
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.infer import pre_quantize_weights
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.nn import modules as M
from micronet_tpu_torch.nn import prepare, qat_dorefa, train_mode
from micronet_tpu_torch.nn.transform import _copy_model
from micronet_tpu_torch.quant import dorefa as tdf
from micronet_tpu_torch.quant.config import QuantConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

EDGE = 1e-5  # grid steps: a pre-round value this close to a half step may flip
GRAD_RTOL = 1e-5  # x max|g|
FWD_ATOL = 1e-5  # logits of size ~1, convs summed in another f32 order


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _near_half(v):
    """Elements of ``v`` (grid units, f64) within EDGE of a half step."""
    return np.abs(v - np.floor(v) - 0.5) < EDGE


def _weight_grid(w, bits):
    t = np.tanh(w.astype(np.float64))
    return (t / (2 * np.abs(t).max()) + 0.5) * ((1 << bits) - 1)


def _assert_grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_weight_codes_and_grad(bits):
    w = _np(bits, (3, 3, 8, 16), 0.7)
    r = _np(100 + bits, w.shape)
    jval, jg = jax.value_and_grad(lambda a: jnp.sum(jdf.quantize_weight(a, bits) * r))(
        jnp.asarray(w))
    jout = np.asarray(jdf.quantize_weight(jnp.asarray(w), bits))
    wt = torch.from_numpy(w).requires_grad_()
    tout = tdf.quantize_weight(wt, bits)
    (tout * torch.from_numpy(r)).sum().backward()
    step = 2.0 / ((1 << bits) - 1)
    codes_j = np.round((jout + 1) / step)
    codes_t = np.round((tout.detach().numpy() + 1) / step)
    ok = (codes_j == codes_t) | _near_half(_weight_grid(w, bits))
    assert ok.all()
    _assert_grad_close(wt.grad.numpy(), np.asarray(jg))
    assert float(jval) == pytest.approx(float((tout.detach() * torch.from_numpy(r)).sum()),
                                        rel=1e-5)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_activation_bit_exact_with_grad(bits):
    x = _np(7 + bits, (4, 6, 5, 3), 6.0)
    x[0, 0, 0, :] = [0.0, 10.0, -3.0]  # the clip's bounds: half the gradient in both
    r = _np(200 + bits, x.shape)
    jout = np.asarray(jdf.quantize_activation(jnp.asarray(x), bits))
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jdf.quantize_activation(a, bits) * r))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tdf.quantize_activation(xt, bits)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(), jout)
    _assert_grad_close(xt.grad.numpy(), jg)
    assert xt.grad[0, 0, 0, 0] == pytest.approx(0.5 * 0.1 * r[0, 0, 0, 0] * 1.0, rel=1e-6)
    codes, scale = tdf.activation_codes(torch.from_numpy(x), bits)
    np.testing.assert_array_equal((codes * scale).numpy(), jout)


def test_32_bits_pass_through_and_1_bit_raises():
    x = torch.randn(3, 4)
    assert tdf.quantize_activation(x, 32) is x and tdf.quantize_weight(x, 32) is x
    for fn in (tdf.quantize_activation, tdf.quantize_weight):
        with pytest.raises(ValueError, match="wbwtab"):
            fn(x, 1)


def _layer_pair(kind, bits, seed):
    jcfg, tcfg = JQuantConfig(a_bits=bits, w_bits=bits), QuantConfig(a_bits=bits, w_bits=bits)
    if kind == "conv":
        jl = jqd.QuantConv2d(4, 6, 3, padding=1, cfg=jcfg, rngs=nnx.Rngs(seed))
        tl = qat_dorefa.QuantConv2d(4, 6, 3, padding=1, cfg=tcfg, device="cpu")
        x = _np(seed, (2, 5, 5, 4), 8.0)
    else:
        jl = jqd.QuantLinear(12, 5, cfg=jcfg, rngs=nnx.Rngs(seed))
        tl = qat_dorefa.QuantLinear(12, 5, cfg=tcfg, device="cpu")
        x = _np(seed, (3, 12), 8.0)
    tl.load_state_dict(cnn_state_from_numpy(_flat(jl)))
    return jl, tl, x


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("bits", [4, 8])
def test_layers_forward_and_grads(kind, bits):
    """A linear loss ``sum(out * r)``: the weight gradient does not depend
    on the codes (the round is straight through), the input gradient
    does; a code that flipped at a half step leaves its output channel
    and the input gradient out of the comparison."""
    jl, tl, x = _layer_pair(kind, bits, 3 + bits)
    w = _flat(jl)[("weight",)]
    jw = np.asarray(jdf.quantize_weight(jnp.asarray(w), bits))
    tw = tdf.quantize_weight(tl.weight.detach(), bits).numpy()
    tw = tw.transpose(2, 3, 1, 0) if kind == "conv" else tw
    flipped = jw != tw
    assert not (flipped & ~_near_half(_weight_grid(w, bits))).any()
    kept = ~flipped.reshape(-1, flipped.shape[-1]).any(0)  # output channels, last axis
    jout = np.asarray(jl(jnp.asarray(x)))
    r = _np(300 + bits, jout.shape)
    jgm, jgx = nnx.grad(lambda m, a: jnp.sum(m(a) * r), argnums=(0, 1))(jl, jnp.asarray(x))
    xt = torch.from_numpy(x if kind == "linear" else x.transpose(0, 3, 1, 2).copy())
    xt.requires_grad_()
    rt = torch.from_numpy(r if kind == "linear" else r.transpose(0, 3, 1, 2).copy())
    tout = tl(xt)
    (tout * rt).sum().backward()
    tout = tout.detach().numpy()
    if kind == "conv":
        tout = tout.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(tout[..., kept], jout[..., kept], rtol=0,
                               atol=FWD_ATOL * max(1, np.abs(jout).max()))
    if kept.all():
        gx = xt.grad.numpy() if kind == "linear" else xt.grad.numpy().transpose(0, 2, 3, 1)
        _assert_grad_close(gx, np.asarray(jgx))
    jg = {".".join(map(str, k)): np.asarray(v[...]) for k, v in jgm.flat_state()}
    for name, p in tl.named_parameters():
        want = jg[name]
        _assert_grad_close(p.grad.numpy(), want.transpose(3, 2, 0, 1) if want.ndim == 4 else want)


def _nin_pair():
    jm = jnin.Net(cfg=[8] * 8, rngs=nnx.Rngs(0))
    tm = tnin.Net(cfg=[8] * 8, device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    return jm, tm


def test_prepare_dorefa_skips_the_first_layer_and_matches_jax():
    jm, tm = _nin_pair()
    cfg = dict(a_bits=4, w_bits=4)
    jq = jprepare(jm, JQuantConfig(**cfg), method="dorefa")
    tq = prepare(tm, QuantConfig(**cfg), method="dorefa", device="cpu")
    kinds = [type(b.conv).__name__ + ("Q" if isinstance(b.conv, qat_dorefa.QuantConv2d) else "")
             for b in tq.model.layers if hasattr(b, "conv")]
    jkinds = [type(b.conv).__name__ + ("Q" if isinstance(b.conv, jqd.QuantConv2d) else "")
              for b in jq.model.layers if hasattr(b, "conv")]
    assert kinds == jkinds and kinds[0] == "Conv2d" and all(k.endswith("Q") for k in kinds[1:])
    assert type(tm.model.layers[1].conv) is M.Conv2d  # prepare copied by default
    jtrain(jq)
    train_mode(tq)
    x = _np(5, (2, 32, 32, 3))
    with torch.no_grad():
        out = tq(torch.from_numpy(x)).numpy()
    jout = np.asarray(jq(jnp.asarray(x)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-4 * max(1, np.abs(jout).max()))


def test_quant_inference_copy_equals_the_training_model():
    _, tm = _nin_pair()
    tq = train_mode(prepare(tm, QuantConfig(a_bits=8, w_bits=8), method="dorefa",
                            device="cpu"))
    inf = _copy_model(tq)
    for m in inf.modules():
        if hasattr(m, "quant_inference"):
            m.quant_inference = True
    pre_quantize_weights(inf)
    conv = inf.model.layers[1].conv
    w = tq.model.layers[1].conv.weight
    assert torch.equal(conv.weight, tdf.quantize_weight(w, 8))
    x = torch.from_numpy(_np(6, (2, 32, 32, 3)))
    with torch.no_grad():
        assert torch.equal(inf(x), tq(x))


def test_conv_transpose_waits_for_its_roadmap_item():
    """DoReFa's ``QuantConvTranspose2d`` (ROADMAP Queue 1 item 7, ported):
    the JAX layer's weights carried by the interop, the same output and
    the same pre-quantized weight (``quant_inference`` copy)."""
    from micronet_tpu.nn import modules as JM

    jl = jqd.QuantConvTranspose2d(4, 6, 4, stride=2, padding=1, cfg=JQuantConfig(a_bits=4,
                                  w_bits=4), rngs=nnx.Rngs(3))
    tl = qat_dorefa.QuantConvTranspose2d(4, 6, 4, stride=2, padding=1,
                                         cfg=QuantConfig(a_bits=4, w_bits=4), device="cpu")
    tl.load_state_dict(cnn_state_from_numpy(_flat(jl), tl))
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  np.asarray(jl.weight[...]).transpose(2, 3, 0, 1))
    x = _np(7, (2, 5, 5, 4), 8.0)
    jout = np.asarray(jl(jnp.asarray(x)))
    with torch.no_grad():
        tout = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert tout.shape == jout.shape == (2, 10, 10, 6)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=FWD_ATOL)
    jq = pre_quantize_weights_j(JM.Sequential(jl)).layers[0].weight[...]
    inf = _copy_model(tl)
    inf.quant_inference = True
    pre_quantize_weights(inf)
    grid = _weight_grid(np.asarray(jl.weight[...]), 4).transpose(2, 3, 0, 1)
    same = ~_near_half(grid)
    np.testing.assert_array_equal(inf.weight.detach().numpy()[same],
                                  np.asarray(jq).transpose(2, 3, 0, 1)[same])
