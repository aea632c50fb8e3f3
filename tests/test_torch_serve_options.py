"""The serving loop's options, and the checks ``chip_smoke.py`` phase 24
makes of them, on the CPU: a loop past 128 slots, sampled streams, kept
sets, chunked prefill.

A tiny W4 Llama built as ``tests/test_torch_llama_serve.py`` builds it
(JAX's ``llama_tiny``, ``quantize_llama(group=16)``, carried over by
``interop``). On the CPU every wrapper runs its plain twin, which has no
regimes: past 128 slots the loop still equals ``generate`` token for
token. The helpers under test are phase 24's own (``_StepLog``,
``outside_kept_set``, ``held_to``), loaded from ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from _torch_parallel_workers import chip_smoke
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu.models import llama as jl
from micronet_tpu_torch.interop import llama_state_from_numpy
from micronet_tpu_torch.models import llama as tl
from micronet_tpu_torch.serve import Request
from micronet_tpu_torch.serve.sampling import generate_sampled, kept_tokens, sample_token

_MAX_SEQ = 32
# the three kinds of sampling settings of phase 24 (chip_smoke.SAMPLING)
_SETTINGS = [(0.8, 50, 1.0), (1.0, 0, 0.9), (0.7, 40, 0.95)]


@pytest.fixture(scope="module")
def cs():
    return chip_smoke()


@pytest.fixture(scope="module")
def model():
    mj = jl.quantize_llama(jl.Llama(jl.llama_tiny(_MAX_SEQ), rngs=nnx.Rngs(0)), group=16)
    cfg = tl.llama_tiny(_MAX_SEQ)
    mt = tl.quantize_llama(tl.Llama(cfg, device="cpu"), group=16)
    mt.load_state_dict(llama_state_from_numpy(
        {path: np.asarray(v[...]) for path, v in nnx.state(mj).flat_state()}, cfg))
    return mt


@pytest.fixture(autouse=True)
def no_cuda_sync(monkeypatch):
    # the phase's timing proxy synchronises the card around every step
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def _requests(n, new, seed, settings=None):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        t, k, p = settings[i % len(settings)] if settings else (0.0, 0, 1.0)
        reqs.append(Request(i, [int(v) for v in rng.integers(0, 64, rng.integers(1, 9))], new,
                            temperature=t, top_k=k, top_p=p, seed=100 + i))
    return reqs


def test_loop_past_128_slots_equals_generate(cs, model):
    """136 slots, all admitted before the first decode step; every stream
    equals ``generate``'s, and eight teacher-forced requests' logits equal
    ``generate``'s position by position within K3's tolerance (the twins
    sum a batched step in another f32 order than one row: measured 2e-7 of
    the largest logit)."""
    reqs = _requests(136, 5, 0)
    forced = list(range(0, 136, 17))
    ref, force = {}, {}
    for rid in forced:
        ref[rid], force[rid], _ = cs._greedy_logits(model, torch.tensor(reqs[rid].prompt), 4)
    done, log, _ = cs._loop_with_log(model, 136, "cpu", reqs, rids=set(forced), force=force)
    assert log.prefills_before_decode == 136 and len(log.decode_s) == 4
    for r in reqs:
        assert done[r.rid] == model.generate(torch.tensor(r.prompt), 5).tolist()
    for rid in forced:
        differ, worst = cs.held_to(f"request {rid}", log.logits[rid], ref[rid],
                                   cs.K3_REL_TOL, forced=True)
        assert differ == [] and worst < cs.K3_REL_TOL


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("setting", _SETTINGS, ids=["top_k", "top_p", "top_k_top_p"])
def test_sampled_loop_equals_generate_sampled(cs, model, setting, paged):
    """Each kind of sampling setting, each request its own seed, through
    three slots (slots recycle): every stream equals its isolated
    ``generate_sampled`` run, and every token lies in its kept set."""
    reqs = _requests(6, 6, 1, [setting])
    kw = dict(paged=True, page_size=8) if paged else {}
    done, log, _ = cs._loop_with_log(model, 3, "cpu", reqs, **kw)
    for r in reqs:
        iso = generate_sampled(model, torch.tensor(r.prompt), r.max_new_tokens,
                               temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                               seed=r.seed)
        assert done[r.rid] == iso.tolist()
    bad, checked = cs.outside_kept_set(reqs, done, log)
    assert bad == [] and checked == 36


def test_kept_set_check_finds_a_token_outside(cs, model):
    """The phase's kept-set check on mixed settings: every token inside;
    a token moved outside its set (request 1 keeps its top 50 of 64: the
    least logit is outside) is found; the set is the one ``sample_token``
    draws from."""
    reqs = _requests(4, 5, 2, [(0.0, 0, 1.0)] + _SETTINGS)
    done, log, _ = cs._loop_with_log(model, 2, "cpu", reqs)
    assert cs.outside_kept_set(reqs, done, log) == ([], 20)
    row = log.logits[1][2]
    outside = int(row.argmin())
    done[1][2] = outside
    assert cs.outside_kept_set(reqs, done, log)[0] == [(1, 2, outside)]
    assert torch.equal(kept_tokens(row, 0.0, 0, 1.0), kept_tokens(row, 0.5, 1, 1.0))
    keep = kept_tokens(row, 0.7, 40, 0.95)
    draws = {int(sample_token(row, torch.Generator().manual_seed(g), 0.7, 40, 0.95))
             for g in range(50)}
    assert all(bool(keep[t]) for t in draws)


def test_chunked_prefill_held_to_the_unchunked_loop(cs, model):
    """Prompts longer than the chunk, through ``prefill_chunk=4``, dense and
    paged, against the unchunked loop: the same tokens, and logits within
    a whole model's tolerance (``MODEL_REL_TOL``: the chunked prefill's
    attention sums in another order, and at these widths one activation
    that crosses a bf16 rounding boundary before a W4 matmul moves the
    logits by ~4e-3 of their largest)."""
    reqs = _requests(5, 4, 3)
    ref, ref_log, _ = cs._loop_with_log(model, 2, "cpu", reqs)
    for kw in ({}, dict(paged=True, page_size=8)):
        done, log, _ = cs._loop_with_log(model, 2, "cpu", reqs, prefill_chunk=4, **kw)
        assert len(log.prefill_s) == sum(-(-len(r.prompt) // 4) for r in reqs)
        assert done == ref
        for r in reqs:
            differ, _ = cs.held_to(f"request {r.rid}", log.logits[r.rid],
                                   ref_log.logits[r.rid], cs.MODEL_REL_TOL, forced=False)
            assert differ == []


def test_held_to_reports_tokens_at_near_ties_and_fails_past_its_bound(cs):
    ref = [torch.tensor([1.0, 0.99999, -1.0]), torch.tensor([2.0, 0.0, -1.0])]
    # argmax 1 against the reference's 0 at a margin of 1e-5, within twice
    # the tolerance (3e-5 x max|row|): allowed, and reported
    assert cs.held_to("tie", [ref[0] + torch.tensor([0, 2e-5, 0]), ref[1]], ref, 3e-5,
                      forced=True)[0] == [0]
    with pytest.raises(SystemExit, match="differ by"):
        cs.held_to("far", [ref[0] + 1e-3, ref[1]], ref, 3e-5, forced=True)


def test_mean_square_sums_rows_in_stages_of_at_most_32(monkeypatch):
    """The Llama's RMSNorm statistic reduces no axis longer than 32 (on the
    card a longer one sums a row in an order that depends on the number of
    rows: see ``mean_square``), pads a ragged axis with zeros, and gives a
    batch's rows what it gives each row alone."""
    from micronet_tpu_torch.models import llama

    sizes = []
    plain_sum = torch.sum

    def recording_sum(t, dim, keepdim=False):
        sizes.append(t.shape[dim])
        return plain_sum(t, dim=dim, keepdim=keepdim)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 4096)).astype(np.float32))
    monkeypatch.setattr(torch, "sum", recording_sum)
    stages = {}
    for width in (4096, 100, 32, 7):
        sizes.clear()
        got = llama.mean_square(x[:, :width])
        stages[width] = list(sizes)
        np.testing.assert_allclose(got.numpy(), (x[:, :width].double() ** 2).mean(-1, keepdim=True),
                                   rtol=1e-6)
        for i in range(5):
            assert torch.equal(got[i : i + 1], llama.mean_square(x[i : i + 1, :width]))
    assert stages == {4096: [32, 32, 4], 100: [32, 4], 32: [32], 7: [7]}
