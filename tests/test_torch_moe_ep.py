"""Expert parallelism of the port (``parallel/moe.py``'s ``moe_apply_ep``
and ``moe_apply_ep_a2a``, ``MoEMLP.use_ep``) in two gloo processes on the
CPU (``tests/_torch_serving_workers.py``), against the JAX package's on
``Mesh(jax.devices()[:2], ("expert",))``, at the sizes of
``tests/test_moe.py`` (dim 16, mlp 32, 8 experts, 24 tokens, capacity
factor 2) and ``tests/test_llm_serving.py``'s EP decoder (dim 16, heads
2, 8 int8 experts, W4 at group 8).

Tolerances are the JAX tests': 1e-5 absolute on MoE values and
gradients (f32 sums in another order: the combine adds each rank's
experts, then the ranks), 2e-5 on the decoder's logits; the greedy tokens
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx
from jax.sharding import Mesh

from _torch_serving_workers import moe_worker, spawn
from micronet_tpu.models import tiny_decoder as jd
from micronet_tpu.parallel import moe as jmoe

DIM, MLP, E, T, CF = 16, 32, 8, 24, 2.0
EP = 2
ATOL, DEC_ATOL = 1e-5, 2e-5
DEC_KW = dict(vocab=32, dim=16, heads=2, depth=1, mlp_dim=32, max_seq=16, moe_experts=E)
NAMES = ("y", "router", "w_up", "w_down", "x")


def _mesh():
    return Mesh(np.array(jax.devices()[:EP]), ("expert",))


def _jax_decoder():
    return nnx.jit(lambda: jd.quantize_decoder(jd.TinyDecoder(**DEC_KW, rngs=nnx.Rngs(0)),
                                               group=8))()


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    z = dict(router=rng.standard_normal((DIM, E)).astype(np.float32) * 0.5,
             w_up=(rng.standard_normal((E, DIM, MLP)) / 4).astype(np.float32),
             w_down=(rng.standard_normal((E, MLP, DIM)) / np.sqrt(MLP)).astype(np.float32),
             x=rng.standard_normal((T, DIM)).astype(np.float32),
             tgt=rng.standard_normal((T, DIM)).astype(np.float32), cf=np.float32(CF),
             dec_kw=np.array(list(DEC_KW.values())))
    dec = _jax_decoder()
    for path, v in nnx.state(dec).flat_state():
        z["dec/" + "/".join(map(str, path))] = np.asarray(v[...])
    np.savez(d / "in.npz", **z)
    spawn(moe_worker, EP, d)
    with np.load(d / "out.npz") as o:
        return z, dec, {k: o[k] for k in o.files}


def _params(z):
    return jmoe.MoEParams(router=jnp.asarray(z["router"]), w_up=jnp.asarray(z["w_up"]),
                          w_down=jnp.asarray(z["w_down"]))


def _sharded_oracle(params, x, top_k):
    """``moe_apply`` on each token shard (the a2a path's per-shard capacity)."""
    return jnp.concatenate([jmoe.moe_apply(params, xs, CF, top_k)
                            for xs in jnp.split(x, EP)])


def _jax_grads(fn, z):
    tgt = jnp.asarray(z["tgt"])

    def loss(p, x):
        y = fn(p, x)
        return jnp.mean((y - tgt) ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        _params(z), jnp.asarray(z["x"]))
    return [y, gp.router, gp.w_up, gp.w_down, gx]


CASES = {
    "ep": lambda p, x: jmoe.moe_apply_ep(p, x, _mesh(), capacity_factor=CF),
    "a2a1": lambda p, x: jmoe.moe_apply_ep_a2a(p, x, _mesh(), capacity_factor=CF, top_k=1),
    "a2a2": lambda p, x: jmoe.moe_apply_ep_a2a(p, x, _mesh(), capacity_factor=CF, top_k=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ep_values_and_grads_equal_jax(moe_run, case):
    """Values and the gradients of the router, both expert tensors and x."""
    z, _, port = moe_run
    for i, ref in enumerate(_jax_grads(CASES[case], z)):
        np.testing.assert_allclose(port[f"{case}_{i}"], np.asarray(ref), rtol=0, atol=ATOL,
                                   err_msg=f"{case} {NAMES[i]}")


@pytest.mark.parametrize("case", ["ep", "a2a1", "a2a2"])
def test_ep_equals_its_dense_oracle(moe_run, case):
    """The oracles of the JAX tests: one dense dispatch for ``moe_apply_ep``,
    ``moe_apply`` on each token shard for ``moe_apply_ep_a2a``."""
    z, _, port = moe_run
    p, x = _params(z), jnp.asarray(z["x"])
    ref = (jmoe.moe_apply(p, x, CF) if case == "ep"
           else _sharded_oracle(p, x, int(case[-1])))
    np.testing.assert_allclose(port[f"{case}_0"], np.asarray(ref), rtol=0, atol=ATOL)


def test_ep_int8_experts_equal_jax(moe_run):
    z, _, port = moe_run
    q = jmoe.quantize_moe(_params(z))
    x = jnp.asarray(z["x"])
    np.testing.assert_allclose(port["ep_int8"],
                               np.asarray(jmoe.moe_apply_ep(q, x, _mesh(), capacity_factor=CF)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        port["a2a_int8"],
        np.asarray(jmoe.moe_apply_ep_a2a(q, x, _mesh(), capacity_factor=CF, top_k=2)),
        rtol=0, atol=ATOL)


def test_use_ep_decoder_equals_jax_and_dense(moe_run):
    """The W4 MoE decoder under ``use_ep``: prefill and decode-step logits
    against JAX's ``use_ep`` model, greedy tokens against JAX's and the
    port's dense path (the state_dict round trips are checked in the
    ranks)."""
    _, dec, port = moe_run
    mesh = _mesh()
    for blk in dec.blocks:
        blk.moe.use_ep(mesh)
    fwd = nnx.jit(lambda m, t, c, o: m.forward(t, c, o))
    toks = jnp.arange(6, dtype=jnp.int32)
    le, ce = fwd(dec, toks, dec.init_cache(), jnp.int32(0))
    l1, _ = fwd(dec, jnp.asarray([3], jnp.int32), ce, jnp.int32(6))
    np.testing.assert_allclose(port["dec_prefill"], np.asarray(le), rtol=0, atol=DEC_ATOL)
    np.testing.assert_allclose(port["dec_step"], np.asarray(l1), rtol=0, atol=DEC_ATOL)
    logits, caches = le, ce
    tok, out = int(jnp.argmax(logits[-1])), []
    for i in range(6):
        out.append(tok)
        logits, caches = fwd(dec, jnp.asarray([tok], jnp.int32), caches, jnp.int32(6 + i))
        tok = int(jnp.argmax(logits[-1]))
    assert port["dec_tokens"].tolist() == out == port["dec_tokens_dense"].tolist()
