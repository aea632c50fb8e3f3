"""BN-gamma pruning in the port against the JAX package: the ``-sr``
gradient term, the masks of the normal, regular and grouped-conv prunes
(equal exactly), the model surgery (the pruned model's state equal, its
forward within 1e-5) and the sparsity report, on NIN (``cfg=[16] * 8``)
and NIN-GC (``cfg=[32] * 8``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from micronet_tpu.models import nin as jnin
from micronet_tpu.models import nin_gc as jnin_gc
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import modules as JM
from micronet_tpu.prune import slimming as jsl
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.models import nin_gc as tnin_gc
from micronet_tpu_torch.nn import eval_mode
from micronet_tpu_torch.nn import modules as M
from micronet_tpu_torch.prune import slimming as tsl
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYERS = 9
FWD_ATOL = 1e-5  # the pruned nets' logits (~1), convs summed in another f32 order


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _pair(kind, cfg, seed=0, ties=True):
    """A JAX net with random BN gammas (some negative, with ``ties`` three
    equal in each layer) and the port's copy of it. Under regular
    rounding tied gammas keep extra channels, so the mask may hold more
    than ``cfg`` (a quirk of the reference, kept in both packages); the
    model surgery needs ``ties=False``."""
    jmod, tmod = (jnin, tnin) if kind == "nin" else (jnin_gc, tnin_gc)
    jm = jmod.Net(cfg=cfg, rngs=nnx.Rngs(seed))
    rng = np.random.RandomState(seed)
    for _, m in nnx.iter_modules(jm):
        if isinstance(m, JM.BatchNorm2d):
            g = rng.rand(m.num_features).astype(np.float32) - 0.1
            if ties:
                g[:2] = g[2]
            m.weight[...] = jnp.asarray(g)
            m.bias[...] = jnp.asarray(0.1 * rng.randn(m.num_features).astype(np.float32))
            m.running_mean[...] = jnp.asarray(0.1 * rng.randn(m.num_features).astype(np.float32))
            m.running_var[...] = jnp.asarray(1 + rng.rand(m.num_features).astype(np.float32))
    tm = tmod.Net(cfg=cfg, device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    return jm, tm


def test_bn_l1_grad_update_adds_s_sign_gamma():
    jm, tm = _pair("nin", [16] * 8)
    jm.model.layers[0].bn.weight[...] = jm.model.layers[0].bn.weight[...].at[3].set(0.0)
    tm.model.layers[0].bn.weight.data[3] = 0.0
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.25), nnx.state(jm, nnx.Param))
    jg = jsl.bn_l1_grad_update(jm, grads, 1e-2)
    for p in tm.parameters():
        p.grad = torch.full_like(p, 0.25)
    tsl.bn_l1_grad_update(tm, 1e-2)
    jflat = {".".join(map(str, k)): np.asarray(v[...]) for k, v in jg.flat_state()}
    for name, p in tm.named_parameters():
        want = jflat[name]
        np.testing.assert_array_equal(p.grad.numpy(),
                                      want.transpose(3, 2, 0, 1) if want.ndim == 4 else want)
    assert float(tm.model.layers[0].bn.weight.grad[3]) == 0.25  # sign(0) = 0
    assert float(tm.model.layers[0].conv.bias.grad[0]) == 0.25  # only BN weights move


@pytest.mark.parametrize("kind,cfg,base,gc", [
    ("nin", [16] * 8, 1, False),
    ("nin", [16] * 8, 4, False),
    ("nin", [12, 16, 8, 16, 16, 12, 16, 16], 3, False),
    ("nin_gc", [32] * 8, 1, True),
])
@pytest.mark.parametrize("percent", [0.3, 0.5, 0.9])
def test_masks_equal_exactly(kind, cfg, base, gc, percent):
    jm, tm = _pair(kind, cfg, seed=int(percent * 10))
    jcfg, jmasks, jratio = jsl.compute_prune_masks(jm, percent, base_number=base, gc=gc,
                                                   layers=LAYERS)
    tcfg, tmasks, tratio = tsl.compute_prune_masks(tm, percent, base_number=base, gc=gc,
                                                   layers=LAYERS)
    assert tcfg == jcfg and tratio == jratio and len(tmasks) == len(jmasks) == LAYERS - 1
    for a, b in zip(tmasks, jmasks):
        np.testing.assert_array_equal(a, b)
    if gc:
        assert tsl.gc_base_numbers(tm) == jsl.gc_base_numbers(jm)
    # the pruned channels' gamma and beta are zeroed in both
    jflat = _flat(jm)
    for i, layer in enumerate(tm.model.layers):
        if hasattr(layer, "bn"):
            np.testing.assert_array_equal(layer.bn.weight.detach().numpy(),
                                          jflat[("model", "layers", i, "bn", "weight")])


@pytest.mark.parametrize("base", [1, 4])
def test_pruned_model_state_and_forward(base):
    jm, tm = _pair("nin", [16] * 8, seed=7, ties=False)
    cfg, masks, _ = jsl.compute_prune_masks(jm, 0.5, base_number=base, layers=LAYERS)
    tcfg, tmasks, _ = tsl.compute_prune_masks(tm, 0.5, base_number=base, layers=LAYERS)
    assert tcfg == cfg
    jnew = jsl.prune_model(jm, jnin.Net(cfg=cfg, rngs=nnx.Rngs(1)), masks, layers=LAYERS)
    tnew = tsl.prune_model(tm, tnin.Net(cfg=tcfg, device="cpu"), tmasks, layers=LAYERS)
    want = cnn_state_from_numpy(_flat(jnew))
    got = tnew.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jeval(jnew), jeval(jm)
    eval_mode(tnew), eval_mode(tm)
    jout = np.asarray(jnew(jnp.asarray(x)))
    with torch.no_grad():
        tout = tnew(torch.from_numpy(x)).numpy()
        # the pruned net reproduces the zeroed big net (a zeroed channel adds 0)
        big = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tout, jout, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(tout, big, rtol=0, atol=FWD_ATOL)


def test_prune_model_refuses_another_architecture():
    _, tm = _pair("nin", [16] * 8)
    _, masks, _ = tsl.compute_prune_masks(tm, 0.5, layers=LAYERS)
    with pytest.raises(ValueError, match="architecture"):
        tsl.prune_model(tm, M.Sequential(M.Conv2d(3, 4, 1, device="cpu")), masks, layers=LAYERS)


def test_sparsity_report_equals_jax():
    jm, tm = _pair("nin_gc", [32] * 8, seed=2)
    assert tsl.sparsity_report(tm) == jsl.sparsity_report(jm)
