"""The port's single-device MoE (``micronet_tpu_torch.parallel.moe``)
against the JAX package's, on the same parameters and inputs.

Parameters come from the JAX package's ``init_moe`` and move as numpy
arrays; inputs are drawn with numpy from a seed. Both run on the CPU in
f32. Tolerances: outputs within 1e-5 (f32 einsums summed in another
order, outputs of size ~1); routing, dispatch and combine tensors equal
exactly; the int8 codes equal and their scales within one ulp (an f32
division on both sides); the auxiliary loss within 1e-6 relative to
max(1, |loss|) (it reaches E = 8, where an f32 ulp is ~1e-6 and the two
softmaxes round apart by a few).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from micronet_tpu.parallel import moe as jm
from micronet_tpu_torch.parallel import moe as tm

DIM, MLP, E, T = 16, 32, 8, 24
_ATOL = 1e-5

# the JAX package's functions compiled whole: a fraction of eager mode's
# per-operation compile time on the CPU
_moe_apply = jax.jit(jm.moe_apply, static_argnums=(2, 3))
_dispatch = jax.jit(jm._dispatch, static_argnums=1)
_dispatch_topk = jax.jit(jm._dispatch_topk, static_argnums=(1, 2))
_quantize_moe = jax.jit(jm.quantize_moe)
_init_moe = jax.jit(jm.init_moe, static_argnums=(0, 1, 2))


def _jax_params(seed):
    return _init_moe(DIM, MLP, E, jax.random.PRNGKey(seed))


def _port(p):
    """The port's MoEParams holding the JAX package's arrays."""
    arr = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return tm.MoEParams(arr(p.router), arr(p.w_up), arr(p.w_down), arr(p.up_scale),
                        arr(p.down_scale))


def _x(seed, t=T):
    return np.random.default_rng(seed).standard_normal((t, DIM)).astype(np.float32)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [float(E), 1.25])  # drop-free, and GShard's training factor
def test_moe_apply_matches_jax(quantized, top_k, cf):
    pj = _jax_params(top_k)
    if quantized:
        pj = _quantize_moe(pj)
    x = _x(10 + top_k)
    yj = _moe_apply(pj, jnp.asarray(x), cf, top_k)
    yt = tm.moe_apply(_port(pj), torch.from_numpy(x), cf, top_k)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=_ATOL)


def _skewed_logits(seed, t=T):
    """Router logits where expert 3 is most tokens' first choice and
    expert 5 their second: a capacity squeeze drops tokens."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, E)).astype(np.float32) * 0.1
    logits[:, 3] += 2.0
    logits[: 2 * t // 3, 5] += 1.5
    return logits


@pytest.mark.parametrize("capacity", [1, 5, T // 2])
def test_capacity_squeeze_drops_the_same_tokens(capacity):
    logits = _skewed_logits(capacity)
    gj, dj = _dispatch(jnp.asarray(logits), capacity)
    gt, dt = tm._dispatch(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    # expert 3 takes its first `capacity` tokens in token order, drops the rest
    kept = dt.numpy()[:, 3].sum(-1)
    first = np.flatnonzero(logits.argmax(-1) == 3)
    assert kept[first].tolist() == [1.0] * capacity + [0.0] * (len(first) - capacity)

    dj2, cj2 = _dispatch_topk(jnp.asarray(logits), capacity, 2)
    dt2, ct2 = tm._dispatch_topk(torch.from_numpy(logits), capacity, 2)
    np.testing.assert_array_equal(dt2.numpy(), np.asarray(dj2))
    np.testing.assert_allclose(ct2.numpy(), np.asarray(cj2), rtol=0, atol=1e-7)
    # choice-major slots: second choices queue behind every first choice, so
    # an expert's first-choice tokens keep their slots before any second
    # choice gets one, and a squeeze drops second choices first
    idx = tm._top_k(torch.from_numpy(logits), 2).numpy()
    d = dt2.numpy().sum(-1)  # (T, E): 1 where the token holds a slot of e
    for e in range(E):
        firsts = np.flatnonzero(idx[:, 0] == e)
        seconds = np.flatnonzero(idx[:, 1] == e)
        n_first = min(len(firsts), capacity)
        assert d[firsts, e].sum() == n_first
        assert d[seconds, e].sum() == min(len(seconds), capacity - n_first)


def test_capacity_one_keeps_only_the_first_token():
    """All tokens to one expert at capacity 1: one token keeps an output
    (the first, by the cumsum order), the rest are dropped to zero."""
    pj = _jax_params(3)
    x = np.abs(_x(3)) + 0.1
    router = np.zeros((DIM, E), np.float32)
    router[:, 0] = 1.0
    pj = pj.replace(router=jnp.asarray(router))
    yj = np.asarray(_moe_apply(pj, jnp.asarray(x), E / T, 1))
    yt = tm.moe_apply(_port(pj), torch.from_numpy(x), E / T).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=_ATOL)
    assert (np.abs(yt).max(1) > 0).tolist() == [True] + [False] * (T - 1)


def test_one_hot_gives_zero_rows_out_of_range():
    """``jax.nn.one_hot``'s zero rows for -1 (not routed) and >= n
    (dropped), where ``torch.nn.functional.one_hot`` raises."""
    idx = np.array([-1, 0, 3, 4, 7], np.int32)
    np.testing.assert_array_equal(tm._one_hot(torch.from_numpy(idx), 4, torch.float32).numpy(),
                                  np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4)))
    with pytest.raises(RuntimeError):
        F.one_hot(torch.from_numpy(idx).long(), 4)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_tied_router_logits_route_as_jax(top_k):
    """Logits from a handful of values, so most rows hold ties (some all
    equal): the top k go to the lower index, as ``jax.lax.top_k`` and
    ``argmax`` give them, and the dispatch is JAX's exactly."""
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 3, (T, E)).astype(np.float32) * 0.5
    logits[0] = 1.0  # every expert tied
    _, ij = jax.lax.top_k(jnp.asarray(logits), top_k)
    assert tm._top_k(torch.from_numpy(logits), top_k).tolist() == np.asarray(ij).tolist()
    cap = jm._capacity(T, E, 1.0, top_k)
    if top_k == 1:
        dj, cj = _dispatch(jnp.asarray(logits), cap)
        dt, ct = tm._dispatch(torch.from_numpy(logits), cap)
    else:
        dj, cj = _dispatch_topk(jnp.asarray(logits), cap, top_k)
        dt, ct = tm._dispatch_topk(torch.from_numpy(logits), cap, top_k)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-7)


def test_expert_mlp_uses_the_tanh_gelu():
    """``jax.nn.gelu`` is the tanh approximation; the erf form would sit
    ~1e-4 away, far outside the tolerance."""
    pj = _jax_params(5)
    rng = np.random.default_rng(5)
    xe = rng.standard_normal((E, 6, DIM)).astype(np.float32) * 2
    yj = np.asarray(jax.jit(jm._expert_mlp)(jnp.asarray(xe), pj.w_up, pj.w_down))
    pt = _port(pj)
    yt = tm._expert_mlp(torch.from_numpy(xe), pt.w_up, pt.w_down).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=_ATOL)
    h = torch.einsum("ecd,edf->ecf", torch.from_numpy(xe), pt.w_up)
    erf = torch.einsum("ecf,efd->ecd", F.gelu(h), pt.w_down).numpy()
    assert np.abs(erf - yj).max() > 10 * _ATOL


def test_quantize_moe_matches_jax():
    pj = _jax_params(6)
    qj = _quantize_moe(pj)
    qt = tm.quantize_moe(_port(pj))
    for name in ("w_up", "w_down"):
        assert getattr(qt, name).dtype == torch.int8
        np.testing.assert_array_equal(getattr(qt, name).numpy(), np.asarray(getattr(qj, name)))
    for name in ("up_scale", "down_scale"):
        got, want = getattr(qt, name).numpy(), np.asarray(getattr(qj, name))
        assert got.shape == want.shape == (E, 1, MLP if name == "up_scale" else DIM)
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(qt.router.numpy(), np.asarray(qj.router))
    # the experts the forward runs: codes times their (expert, column) scale
    np.testing.assert_array_equal(qt.up().numpy(),
                                  qt.w_up.numpy().astype(np.float32) * qt.up_scale.numpy())


def test_quantize_moe_rounds_half_away_from_zero():
    """Codes at exact .5 steps round away from zero (2.5 -> 3, -0.5 -> -1),
    where ``torch.round`` would give 2 and 0."""
    w = torch.zeros((1, 4, 2))
    w[0, :, 0] = torch.tensor([127.0, 2.5, -0.5, -3.5])  # scale 1
    w[0, :, 1] = torch.tensor([-127.0, 0.5, 1.5, -2.5])
    q = tm.quantize_moe(tm.MoEParams(torch.zeros(4, 1), w, w))
    assert q.w_up[0, :, 0].tolist() == [127, 3, -1, -4]
    assert q.w_up[0, :, 1].tolist() == [-127, 1, 2, -3]
    np.testing.assert_array_equal(
        q.w_up.numpy(), np.asarray(_quantize_moe(jm.MoEParams(
            jnp.zeros((4, 1)), jnp.asarray(w.numpy()), jnp.asarray(w.numpy()))).w_up))


@pytest.mark.parametrize("kind", ["random", "uniform", "collapsed", "tied"])
def test_load_balance_loss_matches_jax(kind):
    rng = np.random.default_rng(9)
    logits = {
        "random": rng.standard_normal((256, E)).astype(np.float32),
        "uniform": rng.standard_normal((256, E)).astype(np.float32) * 1e-3,
        "collapsed": np.eye(1, E, 0, dtype=np.float32).repeat(256, 0) * 10,
        "tied": rng.integers(0, 2, (256, E)).astype(np.float32),
    }[kind]
    lj = float(jax.jit(jm.load_balance_loss)(jnp.asarray(logits)))
    lt = float(tm.load_balance_loss(torch.from_numpy(logits)))
    assert abs(lt - lj) <= 1e-6 * max(1.0, abs(lj)), (lt, lj)


def test_init_moe_shapes_and_scales():
    p = tm.init_moe(DIM, MLP, E, device="cpu", generator=torch.Generator().manual_seed(0))
    assert p.router.shape == (DIM, E) and p.w_up.shape == (E, DIM, MLP)
    assert p.w_down.shape == (E, MLP, DIM) and p.up_scale is None
    assert abs(float(p.w_up.std()) - DIM ** -0.5) < 0.05
    assert abs(float(p.router.std()) - 0.02) < 0.005
