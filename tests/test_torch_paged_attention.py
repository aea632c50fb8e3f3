"""The twins of K6/K7 (paged decode attention) and K4b/K5b (split-S decode
attention) against the JAX package, and the long-context dispatch rule.

Each twin runs on the same numpy inputs as the JAX Pallas kernel in
interpret mode and as its XLA oracle. Tolerances:

- against the oracles (``*_xla``): 1e-5 absolute on outputs up to ~2.
  The same f32 arithmetic with the same bf16 rounding points; they differ
  in the order of f32 sums and in exp's last bit (measured: 3e-7).
- against the Pallas kernels: those run an online softmax, so each term
  p * v_scale is rounded to bf16 against a running max where the twins
  (like the oracles and the port's CUDA kernels) round it against the
  global max. A term may then land on the neighbouring bf16 value (2^-8
  relative); measured up to 2.2e-3 at 8-row pages and 6.6e-4 at 128-row
  blocks. Tolerance 5e-3, the JAX package's own for its paged kernel
  against its oracle (tests/test_paged_kv.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micronet_tpu.ops import decode_attention as jda
from micronet_tpu.ops import paged_attention as jpa
from micronet_tpu_torch.ops import decode_attention as tda
from micronet_tpu_torch.ops import paged_attention as tpa
from micronet_tpu_torch.quant import paged_kv as tpk

_ORACLE_ATOL = 1e-5
_KERNEL_ATOL = 5e-3
_D = 128


def _pool(page, slots, mp, h, r, lengths, seed):
    """A pool whose pages are handed out in shuffled order; table entries
    past a slot's length point at the zero page, as the allocator leaves
    them."""
    rng = np.random.default_rng(seed)
    p = 1 + slots * mp
    kc = rng.integers(-127, 128, (p, h, page, _D)).astype(np.int8)
    vc = rng.integers(-127, 128, (p, h, page, _D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (p, h, 1, page)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (p, h, 1, page)).astype(np.float32)
    for a in (kc, vc, ks, vs):
        a[0] = 0  # the zero page
    order = rng.permutation(np.arange(1, p)).reshape(slots, mp).astype(np.int32)
    used = np.arange(mp)[None, :] < -(-np.asarray(lengths)[:, None] // page)
    table = np.where(used, order, 0).astype(np.int32)
    q = rng.standard_normal((slots, h, r, _D)).astype(np.float32)
    cur = (rng.integers(-127, 128, (slots, h, _D)).astype(np.int8),
           rng.uniform(0.001, 0.02, (slots, h)).astype(np.float32),
           rng.integers(-127, 128, (slots, h, _D)).astype(np.int8),
           rng.uniform(0.001, 0.02, (slots, h)).astype(np.float32))
    return (kc, ks, vc, vs, table, np.asarray(lengths, np.int32), q), cur


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("page,r", [(8, 1), (8, 4), (16, 4), (16, 8)])
def test_paged_twins_match_jax_kernels_and_oracles(page, r):
    """K7 and K6 twins at lengths 0 (empty), ragged and full (every page)."""
    slots, mp, h = 3, 4, 2
    s = mp * page
    base, cur = _pool(page, slots, mp, h, r, [0, s // 2 + 3, s], seed=page + r)
    out7 = tpa.paged_decode_attend(*_t(base)).numpy()
    out6 = tpa.paged_decode_attend_cur(*_t(base), *_t(cur)).numpy()
    assert out7.shape == out6.shape == (slots, h, r, _D)
    np.testing.assert_allclose(out7, np.asarray(jpa.paged_decode_attend_xla(*base)),
                               rtol=0, atol=_ORACLE_ATOL)
    np.testing.assert_allclose(out6, np.asarray(jpa.paged_decode_attend_cur_xla(*base, *cur)),
                               rtol=0, atol=_ORACLE_ATOL)
    np.testing.assert_allclose(out7, np.asarray(jpa.paged_decode_attend(*base, interpret=True)),
                               rtol=0, atol=_KERNEL_ATOL)
    np.testing.assert_allclose(
        out6, np.asarray(jpa.paged_decode_attend_cur(*base, *cur, interpret=True)),
        rtol=0, atol=_KERNEL_ATOL)
    assert np.all(out7[0] == 0)  # length 0, no current column: 0, not NaN


def test_paged_twins_equal_dense_twins_on_the_gathered_view():
    """The pool through the table equals the dense twins over
    ``paged_gather_dense`` of each slot, bit for bit."""
    slots, mp, h, r, page = 3, 4, 2, 4, 8
    base, cur = _pool(page, slots, mp, h, r, [5, 0, 32], seed=7)
    kc, ks, vc, vs, table, lengths, q = _t(base)
    pool = tpk.PagedKVCache(kc, ks, vc, vs, table, lengths, torch.zeros(1, dtype=torch.int32),
                            torch.tensor(0, dtype=torch.int32))
    views = [tpk.paged_gather_dense(pool, i) for i in range(slots)]
    dense = [torch.cat([v[j] for v in views]) for j in range(4)]
    bound = lengths[:, None].expand(slots, h).reshape(-1).contiguous()
    q3 = q.reshape(slots * h, r, _D)
    kcur, kscur, vcur, vscur = _t(cur)
    got7 = tpa.paged_decode_attend(*_t(base)).reshape(slots * h, r, _D)
    got6 = tpa.paged_decode_attend_cur(*_t(base), *_t(cur)).reshape(slots * h, r, _D)
    assert torch.equal(got7, tda.decode_attend_q8kv_ref(*dense, q3, bound))
    assert torch.equal(got6, tda.decode_attend_q8kv_cur_ref(
        *dense, q3, bound, kcur.reshape(-1, _D), kscur.reshape(-1), vcur.reshape(-1, _D),
        vscur.reshape(-1)))


def _dense_case(g, s, r, seed):
    rng = np.random.default_rng(seed)
    kc = rng.integers(-127, 128, (g, s, _D)).astype(np.int8)
    vc = rng.integers(-127, 128, (g, s, _D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (g, s)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (g, s)).astype(np.float32)
    q = rng.standard_normal((g, r, _D)).astype(np.float32)
    cur = (rng.integers(-127, 128, (g, _D)).astype(np.int8),
           rng.uniform(0.001, 0.02, (g,)).astype(np.float32),
           rng.integers(-127, 128, (g, _D)).astype(np.int8),
           rng.uniform(0.001, 0.02, (g,)).astype(np.float32))
    return (kc, ks, vc, vs, q), cur


@pytest.mark.parametrize("r", [1, 4])
def test_blocked_twins_match_jax_kernels_and_oracles(r):
    """K5b and K4b twins at S = 512 with bounds 0, 1, a block edge, ragged
    and S, against the JAX S-blocked kernels at block_s = 128."""
    s = 512
    base, cur = _dense_case(5, s, r, seed=20 + r)
    bound = np.array([0, 1, 128, 300, s], np.int32)
    args = (*base, bound)
    out5 = tda.decode_attend_q8kv_blocked(*_t(args), block_s=128).numpy()
    out4 = tda.decode_attend_q8kv_blocked_cur(*_t(args), *_t(cur), block_s=128).numpy()
    np.testing.assert_allclose(out5, np.asarray(jda.decode_attend_q8kv_xla(*args)),
                               rtol=0, atol=_ORACLE_ATOL)
    np.testing.assert_allclose(out4, np.asarray(jda.decode_attend_q8kv_cur_xla(*args, *cur)),
                               rtol=0, atol=_ORACLE_ATOL)
    np.testing.assert_allclose(
        out5, np.asarray(jda.decode_attend_q8kv_blocked(*args, block_s=128, interpret=True)),
        rtol=0, atol=_KERNEL_ATOL)
    np.testing.assert_allclose(
        out4, np.asarray(jda.decode_attend_q8kv_blocked_cur(*args, *cur, block_s=128,
                                                            interpret=True)),
        rtol=0, atol=_KERNEL_ATOL)
    assert np.all(out5[0] == 0)


@pytest.mark.parametrize("s,blocked", [(4096, False), (4224, True), (8192, True)])
def test_long_context_dispatch_depends_on_s_only(monkeypatch, s, blocked):
    """``decode_attend_q8kv(_cur)`` hand over to the blocked wrappers for
    S > 4096, whatever the batch and the bounds."""
    calls = []
    for name in ("decode_attend_q8kv_blocked", "decode_attend_q8kv_blocked_cur"):
        real = getattr(tda, name)
        monkeypatch.setattr(tda, name, lambda *a, _r=real, _n=name, **k: calls.append(_n)
                            or _r(*a, **k))
    g, r = 1, 2
    kc = torch.zeros((g, s, 8), dtype=torch.int8)
    sc = torch.full((g, s), 0.01)
    q = torch.ones((g, r, 8))
    cur = (torch.ones((g, 8), dtype=torch.int8), torch.ones(g), torch.ones((g, 8), dtype=torch.int8),
           torch.ones(g))
    for bound in (0, s):
        b = torch.tensor([bound], dtype=torch.int32)
        tda.decode_attend_q8kv(kc, sc, kc, sc, q, b)
        tda.decode_attend_q8kv_cur(kc, sc, kc, sc, q, b, *cur)
    want = ["decode_attend_q8kv_blocked", "decode_attend_q8kv_blocked_cur"] * 2
    assert calls == (want if blocked else [])
