"""The port's W4 Llama and dense ServeLoop against the JAX package.

A tiny Llama (``llama_tiny``, ``quantize_llama(group=16)``) is built in
JAX, its parameters are carried into the port by ``interop``, and both
run on the CPU: the port through its kernels' plain twins, JAX through
its XLA oracles. Compared: prefill logits, one batched decode step at
ragged per-slot fills, greedy ``generate``, and the ServeLoop's token
streams together with every decode step's logits (the random tiny model
often repeats one argmax token, so tokens alone would prove little).

Tolerance for logits: 1e-4 absolute on logits of size ~1. Both sides do
the same f32 arithmetic with the same bf16 rounding points; they differ
in f32 summation order (measured ~4e-7), which could move an activation
across a bf16 rounding boundary before a W4 matmul (~1e-3 effect on one
logit: larger than the tolerance, so it would be seen, and was not).
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
from micronet_tpu_torch.quant.weight_only import WOLinear
from micronet_tpu_torch.serve import Request, ServeLoop
from micronet_tpu_torch.serve.sampling import generate_sampled

_ATOL = 1e-4
_MAX_SEQ = 32


def _flat_state(model):
    return {path: np.asarray(v[...]) for path, v in nnx.state(model).flat_state()}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with the same W4 weights."""
    mj = jl.quantize_llama(jl.Llama(jl.llama_tiny(_MAX_SEQ), rngs=nnx.Rngs(0)), group=16)
    cfg = tl.llama_tiny(_MAX_SEQ)
    mt = tl.quantize_llama(tl.Llama(cfg, device="cpu"), group=16)
    mt.load_state_dict(llama_state_from_numpy(_flat_state(mj), cfg))
    return mj, mt


class _Recorder:
    """Model proxy that keeps every decode step's logits."""

    def __init__(self, model):
        self._m = model
        self.logits = []

    def __getattr__(self, name):
        return getattr(self._m, name)

    def decode_batch(self, *args):
        logits, caches = self._m.decode_batch(*args)
        self.logits.append(np.asarray(logits))
        return logits, caches


def test_interop_carries_every_tensor(pair):
    mj, mt = pair
    flat = _flat_state(mj)
    sd = mt.state_dict()
    assert set(sd) == {".".join(map(str, p)) for p in flat}
    for path, arr in flat.items():
        t = sd[".".join(map(str, path))]
        assert t.dtype == torch.from_numpy(arr).dtype
        np.testing.assert_array_equal(t.numpy(), arr)
    with pytest.raises(ValueError, match="embed"):
        llama_state_from_numpy({k: v for k, v in flat.items() if k != ("embed",)},
                               tl.llama_tiny(_MAX_SEQ))


def test_prefill_logits_match_jax(pair):
    mj, mt = pair
    toks = [1, 5, 9, 2, 7, 33, 12, 60, 0]
    lj, cj = mj.forward(jnp.asarray(toks, jnp.int32), mj.init_cache(), jnp.int32(0))
    lt, ct = mt.forward(torch.tensor(toks), mt.init_cache(), 0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=_ATOL)
    assert int(ct[0].length) == int(cj[0].length) == len(toks)


def test_decode_batch_step_matches_jax(pair):
    """One batched decode step with slots at fills 3, 8 and 1."""
    mj, mt = pair
    prompts = [[4, 8, 15], [16, 23, 42, 7, 1, 2, 3, 9], [11]]
    b = len(prompts)
    cj, ct = mj.init_cache_batch(b), mt.init_cache_batch(b)
    for slot, p in enumerate(prompts):
        _, one_j = mj.forward(jnp.asarray(p, jnp.int32), mj.init_cache(), jnp.int32(0))
        cj = [c.replace(**{f: getattr(c, f).at[slot].set(getattr(o, f))
                           for f in ("k_codes", "k_scale", "v_codes", "v_scale", "length")})
              for c, o in zip(cj, one_j)]
        _, one_t = mt.forward(torch.tensor(p), mt.init_cache(), 0)
        for c, o in zip(ct, one_t):
            for f in ("k_codes", "k_scale", "v_codes", "v_scale", "length"):
                getattr(c, f)[slot] = getattr(o, f)
    tok = [[3], [50], [21]]
    offs = [len(p) for p in prompts]
    lj, cj = mj.decode_batch(jnp.asarray(tok, jnp.int32), cj, jnp.asarray(offs, jnp.int32))
    lt, ct = mt.decode_batch(torch.tensor(tok), ct, torch.tensor(offs, dtype=torch.int32))
    assert lt.shape == (b, 1, 64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=_ATOL)
    assert ct[1].length.tolist() == np.asarray(cj[1].length).tolist() == [4, 9, 2]


def test_generate_matches_jax(pair):
    """Greedy generate: prefill, then T = 1 forwards (the K5a path)."""
    mj, mt = pair
    prompt = [7, 3, 30, 2]
    gj = np.asarray(mj.generate(jnp.asarray(prompt, jnp.int32), 6))
    gt = mt.generate(torch.tensor(prompt), 6)
    assert gt.tolist() == gj.tolist()


def test_serve_loop_matches_jax_tokens_and_logits(pair):
    """Five greedy requests through two slots (slots recycle), with a
    one-token prompt among them: same token streams and same logits at
    every decode step."""
    mj, mt = pair
    reqs = [([1, 2, 3], 5), ([4, 5, 6, 7, 8], 6), ([9], 4), ([10, 11], 5), ([12, 13, 14, 15], 3)]
    rj, rt = _Recorder(mj), _Recorder(mt)
    loop_j, loop_t = JServeLoop(rj, max_slots=2), ServeLoop(rt, max_slots=2, device="cpu")
    for i, (p, n) in enumerate(reqs):
        loop_j.submit(JRequest(i, p, n))
        loop_t.submit(Request(i, p, n))
    fj, ft = loop_j.run(), loop_t.run()
    for i, (_, n) in enumerate(reqs):
        assert ft[i].output == fj[i].output
        assert len(ft[i].output) == n and all(0 <= t < 64 for t in ft[i].output)
    assert len(rt.logits) == len(rj.logits) > 0
    for step_t, step_j in zip(rt.logits, rj.logits):
        np.testing.assert_allclose(step_t, step_j, rtol=0, atol=_ATOL)


def test_serve_loop_matches_isolated_runs(pair):
    """The determinism contract within the port: greedy and sampled
    requests sharing the batch produce their isolated runs' tokens."""
    _, mt = pair
    reqs = [
        Request(0, [1, 2, 3], 6),
        Request(1, [4, 5, 6, 7], 5, temperature=0.8, top_k=10, seed=3),
        Request(2, [8], 4, temperature=1.2, top_p=0.9, seed=4),
        Request(3, [9, 10], 5, temperature=0.7, seed=5),
    ]
    loop = ServeLoop(mt, max_slots=3, device="cpu")
    for r in reqs:
        loop.submit(r)
    done = loop.run()
    for r in reqs:
        iso = generate_sampled(mt, torch.tensor(r.prompt), r.max_new_tokens,
                               temperature=r.temperature, top_k=r.top_k,
                               top_p=r.top_p, seed=r.seed)
        assert done[r.rid].output == iso.tolist()


def test_prefill_chunk_gives_the_same_tokens(pair):
    _, mt = pair
    outs = []
    for chunk in (0, 4):
        loop = ServeLoop(mt, max_slots=2, prefill_chunk=chunk, device="cpu")
        for i, p in enumerate(([1, 2, 3, 4, 5, 6], [7, 8, 9])):
            loop.submit(Request(i, p, 4))
        outs.append([r.output for _, r in sorted(loop.run().items())])
    assert outs[0] == outs[1]


def test_w4_build_quantizes_as_built():
    """``w4_group`` makes every block linear and the lm_head a WOLinear,
    and the model runs; ``quantize_lm_head=False`` keeps a float head."""
    m = tl.Llama(tl.llama_tiny(16), w4_group=16, device="cpu")
    assert isinstance(m.lm_head, WOLinear)
    assert all(isinstance(getattr(b, n), WOLinear)
               for b in m.blocks for n in ("wqkv", "wo", "gateup", "down"))
    logits, _ = m.forward(torch.tensor([1, 2, 3]), m.init_cache(), 0)
    assert logits.shape == (3, 64) and torch.isfinite(logits).all()
    float_head = tl.Llama(tl.llama_tiny(16), w4_group=16, quantize_lm_head=False, device="cpu")
    assert isinstance(float_head.lm_head, tl.Linear)
