"""The port's TinyDecoder (dense and MoE, float and W4) and its serving
path against the JAX package's, on the same weights.

Each form is built in JAX (``vocab=64, dim=32, heads=2, depth=2,
mlp_dim=64, max_seq=16``; MoE with 4 experts; W4 at group 8, so every
block linear reaches K3's twin), its variables move into the port through
``interop.tiny_decoder_state_from_numpy``, and both run on the CPU: the
port through its kernels' plain twins, JAX through its XLA oracles. The
JAX side runs its ``forward`` compiled (``nnx.jit``): eager mode compiles
each operation on the CPU and would cost tens of seconds here; JAX's
``generate`` is a host loop over ``forward``, driven the same way below.

Tolerances on logits of size ~0.1 to 1: float forms 1e-5 (f32 sums in
another order); W4 forms 1e-4, as ``tests/test_torch_llama_serve.py``
holds the W4 Llama (an activation within an f32 rounding of a bf16
boundary before a W4 matmul moves one term by 2^-8). Prefill against
incremental decode inside the port: decode attention rounds q and
p * v_scale to bf16 (K5a's arithmetic, as JAX's), prefill attention stays
f32, so the two agree to bf16 operand precision (2^-8 relative on each
rounded operand, through two layers and, in W4 forms, the bf16 rounding
of every W4 matmul's input): 1e-2 on these logits, where up to 7.7e-3
was seen (the JAX package's own test allows 2e-2 relative and 5e-3). The
decode step itself is held to JAX's within the form's tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from micronet_tpu.models import tiny_decoder as jd
from micronet_tpu_torch.interop import tiny_decoder_state_from_numpy
from micronet_tpu_torch.models import tiny_decoder as td
from micronet_tpu_torch.quant.weight_only import WOLinear
from micronet_tpu_torch.serve import Request, ServeLoop

KW = dict(vocab=64, dim=32, heads=2, depth=2, mlp_dim=64, max_seq=16)
GROUP = 8
# form -> (experts, W4 group, top_k)
FORMS = {"dense": (0, 0, 1), "dense_w4": (0, GROUP, 1), "moe": (4, 0, 1), "moe2": (4, 0, 2),
         "moe_w4": (4, GROUP, 1), "moe2_w4": (4, GROUP, 2)}
_FLOAT_ATOL, _W4_ATOL, _DECODE_ATOL = 1e-5, 1e-4, 1e-2
PROMPT = [3, 14, 15, 9, 26]


def _flat_state(model):
    return {path: np.asarray(v[...]) for path, v in nnx.state(model).flat_state()}


def _set_top_k(model, k):
    for blk in model.blocks:
        if blk.moe is not None:
            blk.moe.top_k = k


_BASE = {}


def _jax_model(form):
    """The form's JAX model: the dense or MoE float model built once
    (compiled: eager mode compiles every random draw), then cloned,
    quantized (compiled too) and routed as the form says."""
    experts, group, top_k = FORMS[form]
    if experts not in _BASE:
        _BASE[experts] = nnx.jit(lambda: jd.TinyDecoder(**KW, moe_experts=experts,
                                                        rngs=nnx.Rngs(0)))()
    m = nnx.clone(_BASE[experts])
    if group:
        nnx.jit(lambda mm: jd.quantize_decoder(mm, group=group))(m)
    _set_top_k(m, top_k)
    return m


def _port_model(form, flat):
    experts, group, top_k = FORMS[form]
    m = td.TinyDecoder(**KW, moe_experts=experts, device="cpu")
    if group:
        m = td.quantize_decoder(m, group=group)
    _set_top_k(m, top_k)
    m.load_state_dict(tiny_decoder_state_from_numpy(flat, m))
    return m


class _Pair:
    """A JAX model with its compiled forward and the port model holding
    the same weights."""

    def __init__(self, form):
        self.form = form
        self.j = _jax_model(form)
        self.flat = _flat_state(self.j)
        self.t = _port_model(form, self.flat)
        self._fwd = nnx.jit(lambda m, toks, caches, off: m.forward(toks, caches, off))
        self.atol = _W4_ATOL if FORMS[form][1] else _FLOAT_ATOL

    def jax_forward(self, toks, caches=None, offset=0):
        caches = self.j.init_cache() if caches is None else caches
        return self._fwd(self.j, jnp.asarray(toks, jnp.int32), caches, jnp.int32(offset))

    def jax_generate(self, prompt, steps):
        """``TinyDecoder.generate``'s greedy loop over the compiled forward."""
        logits, caches = self.jax_forward(prompt)
        tok = int(jnp.argmax(logits[-1]))
        out, offset = [tok], len(prompt)
        for _ in range(steps - 1):
            logits, caches = self.jax_forward([tok], caches, offset)
            tok = int(jnp.argmax(logits[-1]))
            out.append(tok)
            offset += 1
        return out


_PAIRS = {}


def _pair(form):
    if form not in _PAIRS:
        _PAIRS[form] = _Pair(form)
    return _PAIRS[form]


@pytest.fixture(scope="module", autouse=True)
def _drop_pairs():
    yield
    _PAIRS.clear()
    _BASE.clear()


@pytest.mark.parametrize("form", ["dense", "dense_w4", "moe_w4"])
def test_interop_carries_every_tensor(form):
    p = _pair(form)
    sd = p.t.state_dict()
    assert set(sd) == {".".join(map(str, k)) for k in p.flat}
    for path, arr in p.flat.items():
        t = sd[".".join(map(str, path))]
        assert t.dtype == torch.from_numpy(arr).dtype
        np.testing.assert_array_equal(t.numpy(), arr)
    if FORMS[form][0]:  # int8 experts and their scales, after quantize_()
        assert sd["blocks.0.moe.w_up"].dtype == torch.int8
        assert sd["blocks.1.moe.down_scale"].shape == (4, 1, KW["dim"])
    if FORMS[form][1]:  # the W4 block linears move as packed codes and scales
        assert isinstance(p.t.blocks[0].wq, WOLinear) and sd["blocks.0.wq.packed"].dtype == torch.int8
    with pytest.raises(ValueError, match="embed"):
        tiny_decoder_state_from_numpy({k: v for k, v in p.flat.items() if k != ("embed",)}, p.t)
    with pytest.raises(ValueError, match="pos"):
        tiny_decoder_state_from_numpy({**p.flat, ("pos",): p.flat[("pos",)][:8]}, p.t)
    with pytest.raises(ValueError, match="block index"):
        tiny_decoder_state_from_numpy(
            {**p.flat, ("blocks", 2, "norm1", "weight"): np.ones(KW["dim"], np.float32)}, p.t)


@pytest.mark.parametrize("form", list(FORMS))
def test_prefill_logits_match_jax(form):
    p = _pair(form)
    lj, cj = p.jax_forward(PROMPT)
    lt, ct = p.t.forward(torch.tensor(PROMPT), p.t.init_cache(), 0)
    assert lt.shape == (len(PROMPT), KW["vocab"])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=p.atol)
    for a, b in zip(ct, cj):  # the int8 KV rows the prefill appended
        assert int(a.length) == int(b.length) == len(PROMPT)
        np.testing.assert_allclose(a.dequant_k().numpy(), np.asarray(b.dequant_k()), rtol=0,
                                   atol=1e-3 * np.abs(np.asarray(b.dequant_k())).max())


@pytest.mark.parametrize("form", ["dense_w4", "moe_w4", "moe2_w4"])
def test_prefill_equals_incremental_decode(form):
    """Prefill of [t0..t4] against prefill of [t0..t3] then one T = 1 step
    (K5a's twin) at offset 4: the last position's logits, and the decode
    step's logits against JAX's."""
    p = _pair(form)
    toks = torch.tensor(PROMPT)
    full, _ = p.t.forward(toks, p.t.init_cache(), 0)
    _, caches = p.t.forward(toks[:4], p.t.init_cache(), 0)
    step, caches = p.t.forward(toks[4:], caches, 4)
    assert int(caches[0].length) == 5
    np.testing.assert_allclose(step[0].numpy(), full[-1].numpy(), rtol=0, atol=_DECODE_ATOL)
    _, cj = p.jax_forward(PROMPT[:4])
    sj, _ = p.jax_forward(PROMPT[4:], cj, 4)
    np.testing.assert_allclose(step.numpy(), np.asarray(sj), rtol=0, atol=p.atol)


def test_forward_batch_equals_per_request_forwards():
    """Slots at different fills and offsets: each slot's logits and cache
    rows are its own forward's, bit for bit."""
    m = _pair("moe2_w4").t
    prompts = [[4, 8, 15], [16, 23, 42, 7, 1, 2], [11]]
    caches = m.init_cache_batch(len(prompts))
    singles = []
    for slot, pr in enumerate(prompts):
        _, one = m.forward(torch.tensor(pr), m.init_cache(), 0)
        singles.append(one)
        for full, c in zip(caches, one):
            for f in ("k_codes", "k_scale", "v_codes", "v_scale", "length"):
                getattr(full, f)[slot] = getattr(c, f)
    tok = torch.tensor([[3], [50], [21]])
    offs = torch.tensor([len(pr) for pr in prompts], dtype=torch.int32)
    lb, caches = m.forward_batch(tok, caches, offs)
    assert lb.shape == (3, 1, KW["vocab"])
    for slot in range(len(prompts)):
        one, single = m.forward(tok[slot], singles[slot], int(offs[slot]))
        assert torch.equal(lb[slot], one)
        for full, c in zip(caches, single):
            assert int(full.length[slot]) == int(c.length) == len(prompts[slot]) + 1
            assert torch.equal(full.k_codes[slot], c.k_codes)


@pytest.mark.parametrize("form", ["dense_w4", "moe_w4", "moe2_w4"])
def test_generate_matches_jax(form):
    p = _pair(form)
    got = p.t.generate(torch.tensor(PROMPT), 6).tolist()
    assert got == p.jax_generate(PROMPT, 6)


@pytest.mark.parametrize("form", ["dense_w4", "moe2_w4"])
def test_serve_loop_matches_isolated_generate_and_jax(form):
    """Mixed prompt lengths through two slots and a late arrival that takes
    the first slot to free up: every request's tokens are its isolated
    ``generate``'s and JAX's greedy tokens."""
    p = _pair(form)
    reqs = [Request(0, PROMPT[:4], 6), Request(1, PROMPT, 4)]
    loop = ServeLoop(p.t, max_slots=2, device="cpu")
    for r in reqs:
        loop.submit(r)
    loop.step()
    loop.step()
    late = Request(2, [1, 2, 60, 9], 5)
    loop.submit(late)
    done = loop.run()
    assert sorted(done) == [0, 1, 2]
    for r in reqs + [late]:
        iso = p.t.generate(torch.tensor(r.prompt), r.max_new_tokens).tolist()
        assert done[r.rid].output == iso, r.rid
        assert done[r.rid].output == p.jax_generate(r.prompt, r.max_new_tokens), r.rid


def test_idle_slot_steps_past_max_seq():
    """A slot that finished early steps on idle while another request runs
    to ``max_seq``: its offset outgrows the position table, which clamps
    as JAX's gather does; the requests keep their isolated tokens."""
    m = _pair("moe_w4").t
    reqs = [Request(0, list(range(3, 15)), 2), Request(1, [5, 6], 20)]
    loop = ServeLoop(m, max_slots=2, device="cpu")
    for r in reqs:
        loop.submit(r)
    done = loop.run()
    assert max(loop.host_offsets) > KW["max_seq"]
    assert len(done[1].output) == KW["max_seq"] - 2 + 1  # finished at capacity
    for r in reqs:
        n = len(done[r.rid].output)
        assert done[r.rid].output == m.generate(torch.tensor(r.prompt), n).tolist()


def test_serve_loop_has_dense_slots_only():
    with pytest.raises(ValueError, match="dense slots only"):
        ServeLoop(_pair("dense_w4").t, 2, paged=True, page_size=8, device="cpu")


def test_use_ep_and_top_k_routing_differ_from_top_1():
    m = _pair("moe_w4").t
    assert m.blocks[0].moe.capacity_factor == 4.0  # drop-free serving: cf = E
    two = _pair("moe2_w4").t
    with pytest.raises(ValueError, match="top-1"):  # moe_apply_ep routes top-1 only
        two.blocks[0].moe.use_ep(None)
    toks = torch.tensor(PROMPT)
    l1, _ = m.forward(toks, m.init_cache(), 0)
    l2, _ = two.forward(toks, two.init_cache(), 0)
    assert (l1 - l2).abs().max() > 1e-3  # the same weights, routed top-2


def test_rmsnorm_eps_and_dtype_match_jax():
    """The decoder's RMSNorm is the JAX package's: eps 1e-6 (Llama's is
    1e-5) and the result cast back to x's dtype."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32)).astype(np.float32) * 1e-3  # eps matters at this scale
    w = rng.standard_normal(32).astype(np.float32)
    nj = jd.RMSNorm(32)
    nj.weight[...] = jnp.asarray(w)
    nt = td.DecoderBlock(32, 2, 64, device="cpu").norm1
    nt.weight.data = torch.from_numpy(w)
    with torch.no_grad():
        np.testing.assert_allclose(nt(torch.from_numpy(x)).numpy(),
                                   np.asarray(nj(jnp.asarray(x))), rtol=1e-6, atol=0)
        assert nt(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16


def test_positions_index_the_learned_table():
    """No RoPE: position p adds row p of ``pos``; a token's logits move
    with its offset, and only through that row."""
    m = _pair("dense").t
    tok = torch.tensor([7])
    a, _ = m.forward(tok, m.init_cache(), 0)
    b, _ = m.forward(tok, m.init_cache(), 3)
    assert (a - b).abs().max() > 0
    with torch.no_grad():
        saved = m.pos[3].clone()
        m.pos[3] = m.pos[0]
        c, _ = m.forward(tok, m.init_cache(), 3)
        m.pos[3] = saved
    assert torch.equal(a, c)
    # past the table: the last row, as JAX's gather clamps
    p = _pair("dense_w4")
    late, _ = p.t.forward(tok, p.t.init_cache(), KW["max_seq"] + 4)
    lj, _ = p.jax_forward([7], None, KW["max_seq"] + 4)
    np.testing.assert_allclose(late.numpy(), np.asarray(lj), rtol=0, atol=p.atol)


def test_selftest_decoder_leg_runs_on_cpu(monkeypatch):
    """``quant_test_auto``'s decoder leg (the JAX package's
    ``selftest.py:100-111``): W4 group 8 at dim 16, a two-token forward,
    logits (2, 16)."""
    import micronet_tpu_torch
    from micronet_tpu_torch.models import tiny_decoder

    built = []
    real = tiny_decoder.quantize_decoder

    def record(model, group=0, bits=4):
        built.append((model.dim, group, bits))
        return real(model, group, bits)

    monkeypatch.setattr(tiny_decoder, "quantize_decoder", record)
    micronet_tpu_torch.quant_test_auto(device="cpu")
    assert built == [(16, 8, 4)]


def test_serving_example_runs_on_cpu(monkeypatch, capsys):
    """``examples/serve_llm_torch.py --device cpu``: every request of its
    continuous-batching loop gets its isolated tokens, and the paged loop
    the dense loop's."""
    import runpy
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_llm_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert out.count("== isolated") == 3 and "tokens == dense: True" in out
