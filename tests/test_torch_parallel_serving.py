"""Tensor-parallel and sequence-parallel serving of the port in two gloo
processes on the CPU (``tests/_torch_serving_workers.py``), against the
JAX package on the conftest's CPU devices, and the serving half of the
port's ``graft_entry.dryrun_multichip``.

- The W4 Llama of the dry run (``LlamaConfig(vocab=32, dim=8 * tp,
  n_layers=1, n_heads=2 * tp, n_kv_heads=tp, mlp_dim=16 * tp, max_seq=8)``,
  ``quantize_llama(group=4)``, tp = 2) channel-sharded over ``model``:
  ``forward`` (prefill and a decode step), ``decode_batch`` (two steps)
  and ``decode_batch_paged`` against JAX's ``shard_state`` over
  ``make_mesh(1, 2)``, 1e-4 (the dry run's, ``__graft_entry__.py:155``,
  ``:395``); the paged append's active mask and page count exactly.
- The W4 TinyDecoder of the dry run (heads 2 * tp) sharded: prefill
  logits 1e-4 (``tests/test_torch_tiny_decoder.py``'s W4 bound); its
  ``ServeLoop`` tokens equal the unsharded loop's (checked in the ranks).
- ``prefill_sp`` of ``tests/test_llm_serving.py``'s W4 decoder (dim 16,
  heads 2, depth 2, group 8, 8 tokens) over ``seq`` = 2: logits 1e-4
  against JAX's ``prefill_sp`` and 2e-5 against the port's dense prefill
  (JAX's bound between its two), the int8 codes bit for bit against JAX's
  and the dense prefill's, then dense decode steps from the SP caches
  equal to those from the dense caches bit for bit (in the ranks) and
  within 1e-4 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx
from jax.sharding import Mesh

from _torch_serving_workers import serving_worker, spawn
from micronet_tpu.models import llama as jl
from micronet_tpu.models import tiny_decoder as jd
from micronet_tpu.parallel import make_mesh as jmake_mesh
from micronet_tpu.parallel import shard_state as jshard_state
from micronet_tpu_torch.graft_entry import dryrun_multichip

TP = 2
ATOL, SP_DENSE_ATOL = 1e-4, 2e-5
LCFG = jl.LlamaConfig(vocab=32, dim=8 * TP, n_layers=1, n_heads=2 * TP, n_kv_heads=TP,
                      mlp_dim=16 * TP, max_seq=8, rope_theta=10000.0)
DEC_KW = dict(vocab=32, dim=16, heads=2 * TP, depth=1, mlp_dim=32, max_seq=8)
SP_KW = dict(vocab=32, dim=16, heads=2, depth=2, mlp_dim=32, max_seq=16)
SP_TOKS = np.arange(8) % 32


def _flat(model):
    return {path: np.asarray(v[...]) for path, v in nnx.state(model).flat_state()}


def _put(z, prefix, model):
    for path, v in _flat(model).items():
        z[prefix + "/" + "/".join(map(str, path))] = v


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    lm = nnx.jit(lambda: jl.quantize_llama(jl.Llama(LCFG, rngs=nnx.Rngs(0)), group=4))()
    dec = nnx.jit(lambda: jd.quantize_decoder(jd.TinyDecoder(**DEC_KW, rngs=nnx.Rngs(0)),
                                              group=8))()
    spd = nnx.jit(lambda: jd.quantize_decoder(jd.TinyDecoder(**SP_KW, rngs=nnx.Rngs(0)),
                                              group=8))()
    z = dict(llama_cfg=np.array([LCFG.vocab, LCFG.dim, LCFG.n_layers, LCFG.n_heads,
                                 LCFG.n_kv_heads, LCFG.mlp_dim, LCFG.max_seq]),
             llama_group=np.int64(4), dec_kw=np.array(list(DEC_KW.values())),
             sp_kw=np.array(list(SP_KW.values())), sp_toks=SP_TOKS)
    _put(z, "llama", lm)
    _put(z, "dec", dec)
    _put(z, "sp", spd)
    np.savez(d / "in.npz", **z)
    spawn(serving_worker, TP, d)
    with np.load(d / "out.npz") as o:
        return lm, dec, spd, {k: o[k] for k in o.files}


def _sharded(model):
    gdef, state = nnx.split(model)
    return gdef, jshard_state(state, jmake_mesh(1, TP), "model")


def test_tp_llama_forward_and_decode_batch_equal_jax(serve_run):
    lm, _, _, port = serve_run
    gdef, st = _sharded(lm)
    fwd = jax.jit(lambda s, t, c, o: nnx.merge(gdef, s).forward(t, c, o))
    batch = jax.jit(lambda s, t, c, o: nnx.merge(gdef, s).decode_batch(t, c, o))
    pre, caches = fwd(st, jnp.asarray([1, 2, 3], jnp.int32), lm.init_cache(), jnp.int32(0))
    step, _ = fwd(st, jnp.asarray([5], jnp.int32), caches, jnp.int32(3))
    btoks = jnp.asarray([[1], [2]], jnp.int32)
    boffs = jnp.zeros((2,), jnp.int32)
    b1, bc = batch(st, btoks, lm.init_cache_batch(2), boffs)
    b2, _ = batch(st, btoks, bc, boffs + 1)
    for name, ref in (("llama_prefill", pre), ("llama_step", step), ("llama_batch", b1),
                      ("llama_batch2", b2)):
        np.testing.assert_allclose(port[name], np.asarray(ref), rtol=ATOL, atol=ATOL,
                                   err_msg=name)


def test_tp_llama_decode_batch_paged_equals_jax(serve_run):
    """The paged step over per-layer pools: logits, and the append taking
    one page for the one active lane."""
    lm, _, _, port = serve_run
    gdef, st = _sharded(lm)
    paged = jax.jit(lambda s, t, c, o, a: nnx.merge(gdef, s).decode_batch_paged(t, c, o, a))
    pc = lm.init_paged_cache(slots=2, page_size=4, num_pages=9)
    lp, pc2 = paged(st, jnp.asarray([[1], [2]], jnp.int32), pc, jnp.zeros((2,), jnp.int32),
                    jnp.asarray([True, False]))
    np.testing.assert_allclose(port["llama_paged"], np.asarray(lp), rtol=ATOL, atol=ATOL)
    assert port["llama_paged_lengths"].tolist() == np.asarray(pc2[0].lengths).tolist() == [1, 0]
    assert int(port["llama_paged_pages"]) == int(pc[0].free_top) - int(pc2[0].free_top) == 1


def test_tp_tiny_decoder_equals_jax(serve_run):
    _, dec, _, port = serve_run
    gdef, st = _sharded(dec)
    fwd = jax.jit(lambda s, t, c, o: nnx.merge(gdef, s).forward(t, c, o))
    ref, _ = fwd(st, jnp.arange(5, dtype=jnp.int32), dec.init_cache(), jnp.int32(0))
    np.testing.assert_allclose(port["dec_prefill"], np.asarray(ref), rtol=0, atol=ATOL)


def test_sp_prefill_equals_jax(serve_run):
    _, _, spd, port = serve_run
    mesh = Mesh(np.array(jax.devices()[:TP]), ("seq",))
    toks = jnp.asarray(SP_TOKS, jnp.int32)
    gdef, st = nnx.split(spd)
    prefill = jax.jit(lambda s, t: nnx.merge(gdef, s).prefill_sp(t, spd.init_cache(), mesh))
    logits, caches = prefill(st, toks)
    np.testing.assert_allclose(port["sp_prefill"], np.asarray(logits), rtol=0, atol=ATOL)
    for i, c in enumerate(caches):
        np.testing.assert_array_equal(port[f"sp_k_codes{i}"], np.asarray(c.k_codes))
    fwd = jax.jit(lambda s, t, c, o: nnx.merge(gdef, s).forward(t, c, o))
    for step, tok in enumerate((5, 7, 11)):
        ls, caches = fwd(st, jnp.asarray([tok], jnp.int32), caches, jnp.int32(8 + step))
        np.testing.assert_allclose(port[f"sp_step{step}"], np.asarray(ls), rtol=0, atol=ATOL)


def test_sp_prefill_equals_the_dense_prefill(serve_run):
    _, _, _, port = serve_run
    np.testing.assert_allclose(port["sp_prefill"], port["sp_dense"], rtol=0,
                               atol=SP_DENSE_ATOL)


def test_dryrun_multichip_serving_half():
    """Both halves of the dry run at two ranks on the CPU: every check of
    ``__graft_entry__.py:108-345`` and ``:375-424`` at its sizes and
    tolerances (each raises on a failure)."""
    dryrun_multichip(2, device="cpu", serving=True)
