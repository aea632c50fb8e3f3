"""The port's paged ServeLoop against the JAX package's, and against the
port's dense loop.

A tiny W4 Llama (``llama_tiny(32)``, ``quantize_llama(group=16)``) is
built once in JAX and carried into the port by ``llama_state_from_numpy``;
both run on the CPU (the port's kernels through their plain twins, JAX's
paged attention through its gather-dense oracle). Token streams must be
equal, and so must every paged decode step's logits within 1e-4 (the
tolerance of tests/test_torch_llama_serve.py, for the same reason: same
arithmetic and bf16 rounding points, f32 sums in another order).

Two quirks of the JAX loop are reproduced and checked against it:
admission compares the pool's free pages with the request's need at that
moment, so requests admitted together may outgrow the pool and be
truncated; and a request bigger than the whole pool gets a partial insert
and emits one token computed on it before it is finished.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from micronet_tpu.models import llama as jl
from micronet_tpu.serve import Request as JRequest, ServeLoop as JServeLoop
from micronet_tpu_torch.interop import llama_state_from_numpy
from micronet_tpu_torch.models import llama as tl
from micronet_tpu_torch.quant.paged_kv import paged_hbm_bytes
from micronet_tpu_torch.quant.kv_cache import kv_cache_bytes
from micronet_tpu_torch.serve import Request, ServeLoop

_ATOL = 1e-4
_MAX_SEQ = 32
# every loop compared with JAX's: 2 slots, a pool of 3 usable pages of 8
# rows (JAX compiles its pool operations once for the file)
_PAGED = dict(paged=True, page_size=8, num_pages=4)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with the same W4 weights."""
    mj = jl.quantize_llama(jl.Llama(jl.llama_tiny(_MAX_SEQ), rngs=nnx.Rngs(0)), group=16)
    cfg = tl.llama_tiny(_MAX_SEQ)
    mt = tl.quantize_llama(tl.Llama(cfg, device="cpu"), group=16)
    flat = {path: np.asarray(v[...]) for path, v in nnx.state(mj).flat_state()}
    mt.load_state_dict(llama_state_from_numpy(flat, cfg))
    return mj, mt


class _Recorder:
    """Model proxy that keeps every paged decode step's logits."""

    def __init__(self, model):
        self._m = model
        self.logits = []

    def __getattr__(self, name):
        return getattr(self._m, name)

    def decode_batch_paged(self, *args):
        logits, caches = self._m.decode_batch_paged(*args)
        self.logits.append(np.asarray(logits))
        return logits, caches


def _run(loop, reqs, request, late=()):
    """Submit ``reqs``, step twice, submit ``late``, run to the end;
    returns {rid: output}."""
    for i, (p, n) in enumerate(reqs):
        loop.submit(request(i, p, n))
    if late:
        loop.step()
        loop.step()
        for i, (p, n) in enumerate(late, len(reqs)):
            loop.submit(request(i, p, n))
    return {rid: r.output for rid, r in loop.run().items()}


_MIXED = [([3, 14, 15], 6), ([9, 26, 5, 35, 8], 4)]
_LATE = [([1, 2, 7], 5)]  # prompt lengths repeat: JAX compiles fewer prefills


def test_paged_loop_matches_jax_paged_loop_and_dense_loop(pair):
    """Mixed lengths, a late arrival and slot recycling: the port's paged
    loop gives JAX's paged loop's tokens and logits, the port's dense
    loop's tokens, and request 0's isolated generate run."""
    mj, mt = pair
    rj, rt = _Recorder(mj), _Recorder(mt)
    got_j = _run(JServeLoop(rj, max_slots=2, **_PAGED), _MIXED, JRequest, _LATE)
    got_t = _run(ServeLoop(rt, 2, device="cpu", **_PAGED), _MIXED, Request, _LATE)
    dense = _run(ServeLoop(mt, 2, device="cpu"), _MIXED, Request, _LATE)
    assert got_t == got_j == dense
    assert len(rt.logits) == len(rj.logits) > 0
    for a, b in zip(rt.logits, rj.logits):
        np.testing.assert_allclose(a, b, rtol=0, atol=_ATOL)
    assert got_t[0] == mt.generate(torch.tensor([3, 14, 15]), 6).tolist()


def test_pages_return_to_the_pool_on_finish(pair):
    _, mt = pair
    loop = ServeLoop(mt, 2, paged=True, page_size=8, device="cpu")
    top0 = int(loop.caches[0].free_top)
    _run(loop, _MIXED, Request)
    assert not loop.queue and all(r is None for r in loop.slot_req)
    for c in loop.caches:
        assert int(c.free_top) == top0
        assert int(c.lengths.sum()) == 0 and int(c.page_table.max()) == 0


def test_admission_defers_until_the_pool_has_room(pair):
    """1 usable page of 8: each request reserves it (prompt plus the rows
    its decode appends: 3 + 5 and 5 + 3), so the second waits at the head
    of the queue until the first finishes, and both give their isolated
    runs' tokens."""
    _, mt = pair
    loop = ServeLoop(mt, 2, paged=True, page_size=8, num_pages=2, device="cpu")
    for i, (p, n) in enumerate(_MIXED):
        loop.submit(Request(i, p, n))
    loop.step()
    assert [r is not None for r in loop.slot_req] == [True, False]
    assert [r.rid for r in loop.queue] == [1]
    assert loop.deferred == 1
    done = loop.run()
    assert loop.deferred >= 1
    for i, (p, n) in enumerate(_MIXED):
        assert done[i].output == mt.generate(torch.tensor(p), n).tolist()


def test_pool_smaller_than_dense_capacity_serves_everything(pair):
    """A pool under half the dense cache's bytes serves six requests
    through four slots with the dense loop's tokens."""
    _, mt = pair
    reqs = [([2 + i, 11 + i], 3) for i in range(6)]
    dense = ServeLoop(mt, 4, device="cpu")
    paged = ServeLoop(mt, 4, paged=True, page_size=8, num_pages=7, device="cpu")
    assert (sum(paged_hbm_bytes(c) for c in paged.caches)
            < sum(kv_cache_bytes(c) for c in dense.caches) / 2)
    assert _run(paged, reqs, Request) == _run(dense, reqs, Request)


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_gives_the_exact_prefill_tokens(pair, paged):
    """Chunks of 4 with pads of 0, 3 and a prompt shorter than a chunk."""
    _, mt = pair
    reqs = [([3, 14, 15, 9], 4), ([9, 26, 5, 35, 8], 4), ([7, 7], 5)]
    kw = dict(paged=True, page_size=8) if paged else {}
    exact = _run(ServeLoop(mt, 2, device="cpu"), reqs, Request)
    assert _run(ServeLoop(mt, 2, prefill_chunk=4, device="cpu", **kw), reqs, Request) == exact


def test_exhaustion_truncates_to_a_prefix_as_jax_does(pair):
    """Two requests each reserve 2 of the 3 free pages (5 prompt rows plus
    11 appended) and are admitted one after the other, since the check is
    made at admission only; both need their second page at the same step
    and only one is left. The slot whose append is dropped is finished at
    once: its tokens are a prefix of the dense run's, equal to JAX's, and
    every page returns."""
    mj, mt = pair
    reqs = [([3, 14, 15, 9, 26], 12), ([9, 26, 5, 35, 8], 12)]
    got_j = _run(JServeLoop(mj, max_slots=2, **_PAGED), reqs, JRequest)
    loop = ServeLoop(mt, 2, device="cpu", **_PAGED)
    got_t = _run(loop, reqs, Request)
    full = _run(ServeLoop(mt, 2, device="cpu"), reqs, Request)
    assert got_t == got_j
    for rid in (0, 1):
        assert 0 < len(got_t[rid]) <= len(full[rid])
        assert got_t[rid] == full[rid][: len(got_t[rid])]
    assert any(len(got_t[rid]) < len(full[rid]) for rid in (0, 1))
    assert all(int(c.free_top) == 3 for c in loop.caches)


def test_request_bigger_than_the_pool_gets_a_partial_insert_as_jax_does(pair):
    """3 usable pages of 8 and a 26-token prompt: admitted once the pool is
    free, its insert keeps 24 rows, the first decode step attends to them
    and emits a second token, then the dropped append finishes it. Both
    packages emit the same two tokens; every page returns."""
    mj, mt = pair
    reqs = [(list(range(1, 27)), 4)]
    got_j = _run(JServeLoop(mj, max_slots=2, **_PAGED), reqs, JRequest)
    loop = ServeLoop(mt, 2, device="cpu", **_PAGED)
    got_t = _run(loop, reqs, Request)
    assert got_t == got_j and len(got_t[0]) == 2
    assert all(int(c.free_top) == 3 for c in loop.caches)


def test_forward_batch_matches_jax(pair):
    """``forward_batch``: each slot's forward on its own cache (ragged
    fills 3, 5 and 0) gives JAX's vmapped logits and fill pointers."""
    mj, mt = pair
    fills = [[4, 8, 15], [16, 23, 42, 7, 1], []]
    b = len(fills)
    cj, ct = mj.init_cache_batch(b), mt.init_cache_batch(b)
    for slot, p in enumerate(fills):
        if not p:
            continue
        _, one_j = mj.forward(jnp.asarray(p, jnp.int32), mj.init_cache(), jnp.int32(0))
        cj = [c.replace(**{f: getattr(c, f).at[slot].set(getattr(o, f))
                           for f in ("k_codes", "k_scale", "v_codes", "v_scale", "length")})
              for c, o in zip(cj, one_j)]
        _, one_t = mt.forward(torch.tensor(p), mt.init_cache(), 0)
        for c, o in zip(ct, one_t):
            for f in ("k_codes", "k_scale", "v_codes", "v_scale", "length"):
                getattr(c, f)[slot] = getattr(o, f)
    tok = [[3, 9], [50, 1], [21, 7]]
    offs = [len(p) for p in fills]
    lj, cj = mj.forward_batch(jnp.asarray(tok, jnp.int32), cj, jnp.asarray(offs, jnp.int32))
    lt, ct = mt.forward_batch(torch.tensor(tok), ct, torch.tensor(offs, dtype=torch.int32))
    assert lt.shape == (b, 2, 64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=_ATOL)
    assert ct[0].length.tolist() == np.asarray(cj[0].length).tolist() == [5, 7, 2]


class _NoDecodeBatch:
    """Model proxy without ``decode_batch``."""

    def __init__(self, model):
        self._m = model

    def __getattr__(self, name):
        if name == "decode_batch":
            raise AttributeError(name)
        return getattr(self._m, name)


def test_loop_steps_through_forward_batch_without_decode_batch(pair):
    """A model without ``decode_batch`` is stepped through
    ``forward_batch``, with the same tokens."""
    _, mt = pair
    got = _run(ServeLoop(_NoDecodeBatch(mt), 2, device="cpu"), _MIXED, Request, _LATE)
    assert got == _run(ServeLoop(mt, 2, device="cpu"), _MIXED, Request, _LATE)
