"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Every test here needs a CUDA card and skips without one. The file
imports torch and numpy only (no JAX), so it also runs on a machine that
has no JAX, without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from micronet_tpu_torch.ops import decode_attention as tda
from micronet_tpu_torch.ops import int4_matmul as tim
from micronet_tpu_torch.ops import int_matmul as ti8
from micronet_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

# On the card the kernel's sums run in another order than the twin's, and
# a term p * v_scale lying within an ulp of a bf16 rounding boundary can
# round to the neighbouring bf16 value (2^-8 relative); 1e-3 covers such a
# flip on a term carrying up to a tenth of the softmax mass.
_ATTN_ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("k,n,g", [(1024, 768, 128), (512, 100, 64)])
def test_int4_hl8_kernel_matches_twin(cuda, m, k, n, g):
    gen = _gen(m)
    w = torch.randn((k, n), device=cuda, generator=gen) * 0.05
    w_q, gs = tim.quantize_int4_weight_grouped(w, g)
    packed = tim.pack_int4_hl8(w_q)
    x = torch.randn((m, k), device=cuda, generator=gen)
    before = tim.int4_matmul_grouped_hl8.launches
    out = tim.int4_matmul_grouped_hl8(x, packed, gs)
    torch.cuda.synchronize()
    assert tim.int4_matmul_grouped_hl8.launches == before + 1
    ref = tim.int4_matmul_grouped_hl8_ref(x, packed, gs)
    # exact products, f32 sums in another order over K terms
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5 * ref.abs().max().item())
    # a row's result does not depend on the rows sharing its call
    alone = tim.int4_matmul_grouped_hl8(x[:1].contiguous(), packed, gs)
    assert torch.equal(alone[0], out[0])


# (K, N, group) for K3's two regimes: N = 768 and N = 100 (ragged column tiles; 100 and 136
# not multiples of 16, so 4-byte copies); K/2 = 336 in stages of 48 rows (a group shorter
# than regime B's 64-row stage) and a 256-row group (four stages); groups 32 to 256; a group of
# 50 rows, not a multiple of 16, with K/2 = 500 not a multiple of a 16-row k-tile (regime A at
# every M, groups cutting k-tiles)
_K3_SHAPES = [(1024, 768, 128), (512, 100, 64), (640, 256, 32), (672, 136, 48),
              (1024, 512, 256), (1000, 400, 50)]


@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 128, 129, 300, 1024])
@pytest.mark.parametrize("k,n,g", _K3_SHAPES)
def test_int4_hl8_kernel_regimes_match_twin(cuda, m, k, n, g):
    """K3 in the regime its M and group choose, against its twin within
    2e-5 x max|twin|, and two calls equal bit for bit. Regime A (M <= 128,
    or a group that is not a multiple of 16): the first, a middle and the
    last row alone equal the batch's rows bit for bit. Regime B: the same
    rows at other positions and at another M > 128 are equal bit for bit,
    and a row alone (regime A) agrees within the tolerance."""
    gen = _gen(1000 + m + k + n + g)
    w = torch.randn((k, n), device=cuda, generator=gen) * 0.05
    w_q, gs = tim.quantize_int4_weight_grouped(w, g)
    packed = tim.pack_int4_hl8(w_q)
    x = torch.randn((m, k), device=cuda, generator=gen)
    before = tim.int4_matmul_grouped_hl8.launches
    out = tim.int4_matmul_grouped_hl8(x, packed, gs)
    torch.cuda.synchronize()
    assert tim.int4_matmul_grouped_hl8.launches == before + 1
    ref = tim.int4_matmul_grouped_hl8_ref(x, packed, gs)
    tol = 2e-5 * ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    assert torch.equal(tim.int4_matmul_grouped_hl8(x, packed, gs), out)
    rows = sorted({0, m // 2, m - 1})
    alone = [tim.int4_matmul_grouped_hl8(x[r:r + 1].contiguous(), packed, gs)[0] for r in rows]
    if tim._k3_regime(m, g) == "A":
        for r, a in zip(rows, alone):
            assert torch.equal(a, out[r])
        return
    for r, a in zip(rows, alone):
        torch.testing.assert_close(a, out[r], rtol=0, atol=tol)
    shift = m // 3 + 1  # every row at another position (and another 128-row tile)
    rolled = tim.int4_matmul_grouped_hl8(torch.roll(x, shift, 0).contiguous(), packed, gs)
    assert torch.equal(torch.roll(rolled, -shift, 0), out)
    m2 = max(129, m // 2 + 1)  # another M of regime B, holding rows 0 and m // 2
    part = tim.int4_matmul_grouped_hl8(x[:m2].contiguous(), packed, gs)
    assert torch.equal(part, out[:m2])


def test_int4_hl8_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn((2, 256), device=cuda)
    packed = torch.zeros((128, 6), dtype=torch.int8, device=cuda)  # N % 4 != 0
    with pytest.raises(ValueError):
        tim.int4_matmul_grouped_hl8(x, packed, torch.ones((2, 6), device=cuda))


def _attn_case(g, s, d, r, seed):
    gen = _gen(seed)
    ri = lambda *shape: torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda",
                                      generator=gen)
    rf = lambda *shape: torch.rand(shape, device="cuda", generator=gen) * 0.02 + 1e-3
    q = torch.randn((g, r, d), device="cuda", generator=gen)
    return (ri(g, s, d), rf(g, s), ri(g, s, d), rf(g, s), q), (ri(g, d), rf(g), ri(g, d), rf(g))


@pytest.mark.parametrize("r,d", [(1, 128), (4, 128), (2, 64), (8, 128)])
def test_decode_attention_kernels_match_twins(cuda, r, d):
    s = 256
    base, cur = _attn_case(6, s, d, r, seed=50 + r)
    bound = torch.tensor([0, 1, s - 1, s, 100, 2], dtype=torch.int32, device=cuda)
    n5, n4 = tda.decode_attend_q8kv.launches, tda.decode_attend_q8kv_cur.launches
    out5 = tda.decode_attend_q8kv(*base, bound)
    out4 = tda.decode_attend_q8kv_cur(*base, bound, *cur)
    torch.cuda.synchronize()
    assert tda.decode_attend_q8kv.launches == n5 + 1
    assert tda.decode_attend_q8kv_cur.launches == n4 + 1
    torch.testing.assert_close(out5, tda.decode_attend_q8kv_ref(*base, bound),
                               rtol=0, atol=_ATTN_ATOL)
    torch.testing.assert_close(out4, tda.decode_attend_q8kv_cur_ref(*base, bound, *cur),
                               rtol=0, atol=_ATTN_ATOL)
    assert torch.all(out5[0] == 0)  # bound 0: nothing visible


def test_cur_kernel_equals_append_then_attend_bit_for_bit(cuda):
    """K4a at bound b and K5a at bound b + 1 over a cache whose row b holds
    the current row run the same sums in the same order."""
    s = 300
    (kc, ks, vc, vs, q), cur = _attn_case(5, s + 1, 128, 4, seed=60)
    bound = torch.tensor([0, 1, 77, 299, 300], dtype=torch.int32, device=cuda)
    kc2, ks2, vc2, vs2 = kc.clone(), ks.clone(), vc.clone(), vs.clone()
    for i, b in enumerate(bound.tolist()):
        kc2[i, b], ks2[i, b], vc2[i, b], vs2[i, b] = cur[0][i], cur[1][i], cur[2][i], cur[3][i]
    a = tda.decode_attend_q8kv_cur(kc, ks, vc, vs, q, bound, *cur)
    b = tda.decode_attend_q8kv(kc2, ks2, vc2, vs2, q, bound + 1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("r", [1, 4, 8])
def test_split_kernels_match_twins(cuda, r):
    """K5b and K4b (the split-S regime, any S through the blocked wrappers)
    at bounds 0, 1, split edges (512 positions a split), ragged and S."""
    s = 1200
    base, cur = _attn_case(8, s, 128, r, seed=70 + r)
    bound = torch.tensor([0, 1, 511, 512, 513, 1024, s - 1, s], dtype=torch.int32, device=cuda)
    n5, n4 = tda.decode_attend_q8kv_blocked.launches, tda.decode_attend_q8kv_blocked_cur.launches
    out5 = tda.decode_attend_q8kv_blocked(*base, bound)
    out4 = tda.decode_attend_q8kv_blocked_cur(*base, bound, *cur)
    torch.cuda.synchronize()
    assert tda.decode_attend_q8kv_blocked.launches == n5 + 1
    assert tda.decode_attend_q8kv_blocked_cur.launches == n4 + 1
    torch.testing.assert_close(out5, tda.decode_attend_q8kv_ref(*base, bound),
                               rtol=0, atol=_ATTN_ATOL)
    torch.testing.assert_close(out4, tda.decode_attend_q8kv_cur_ref(*base, bound, *cur),
                               rtol=0, atol=_ATTN_ATOL)
    assert torch.all(out5[0] == 0)  # bound 0: 0, not NaN


def test_long_cache_takes_the_split_kernels(cuda):
    """Past S = 4096 the whole-cache wrappers launch K5b / K4b, not K5a / K4a."""
    base, cur = _attn_case(2, 4224, 128, 4, seed=80)
    bound = torch.tensor([4224, 3000], dtype=torch.int32, device=cuda)
    before = (tda.decode_attend_q8kv.launches, tda.decode_attend_q8kv_blocked.launches,
              tda.decode_attend_q8kv_cur.launches, tda.decode_attend_q8kv_blocked_cur.launches)
    out5 = tda.decode_attend_q8kv(*base, bound)
    out4 = tda.decode_attend_q8kv_cur(*base, bound, *cur)
    torch.cuda.synchronize()
    after = (tda.decode_attend_q8kv.launches, tda.decode_attend_q8kv_blocked.launches,
             tda.decode_attend_q8kv_cur.launches, tda.decode_attend_q8kv_blocked_cur.launches)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 0, 1]
    torch.testing.assert_close(out5, tda.decode_attend_q8kv_ref(*base, bound),
                               rtol=0, atol=_ATTN_ATOL)
    torch.testing.assert_close(out4, tda.decode_attend_q8kv_cur_ref(*base, bound, *cur),
                               rtol=0, atol=_ATTN_ATOL)


def test_split_cur_kernel_equals_append_then_attend_bit_for_bit(cuda):
    """K4b at bound b equals K5b at b + 1 over a cache whose row b holds the
    current row, at split edges too."""
    s = 1100
    (kc, ks, vc, vs, q), cur = _attn_case(6, s + 1, 128, 4, seed=90)
    bound = torch.tensor([0, 1, 511, 512, 1023, 1100], dtype=torch.int32, device=cuda)
    kc2, ks2, vc2, vs2 = kc.clone(), ks.clone(), vc.clone(), vs.clone()
    for i, b in enumerate(bound.tolist()):
        kc2[i, b], ks2[i, b], vc2[i, b], vs2[i, b] = cur[0][i], cur[1][i], cur[2][i], cur[3][i]
    a = tda.decode_attend_q8kv_blocked_cur(kc, ks, vc, vs, q, bound, *cur)
    b = tda.decode_attend_q8kv_blocked(kc2, ks2, vc2, vs2, q, bound + 1)
    assert torch.equal(a, b)


def _paged_case(slots, h, r, page, mp, seed):
    """A shuffled pool, its table, lengths 0, 1, page edges, ragged and
    S, the query and current rows."""
    gen = _gen(seed)
    p = 1 + slots * mp
    ri = lambda *shape: torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda",
                                      generator=gen)
    rf = lambda *shape: torch.rand(shape, device="cuda", generator=gen) * 0.02 + 1e-3
    s = mp * page
    lengths = torch.tensor(([0, 1, page, page + 1, s // 2 + 3, s - 1, s] * slots)[:slots],
                           dtype=torch.int32, device="cuda")
    order = torch.randperm(p - 1, generator=gen, device="cuda").to(torch.int32) + 1
    used = (torch.arange(mp, device="cuda")[None, :] * page) < lengths[:, None]
    table = torch.where(used, order.reshape(slots, mp), 0).to(torch.int32).contiguous()
    pool = (ri(p, h, page, 128), rf(p, h, 1, page), ri(p, h, page, 128), rf(p, h, 1, page))
    q = torch.randn((slots, h, r, 128), device="cuda", generator=gen)
    cur = (ri(slots, h, 128), rf(slots, h), ri(slots, h, 128), rf(slots, h))
    return pool, table, lengths, q, cur


@pytest.mark.parametrize("page,mp", [(16, 8), (16, 320), (512, 10)])  # S 128, 5120, 5120
def test_paged_kernels_equal_dense_kernels_on_the_gathered_view(cuda, page, mp):
    """K6 and K7 against their twins, and bit for bit against the dense
    kernel of the same regime (K4a/K5a up to S = 4096, K4b/K5b past it) over
    the view gathered from the pool."""
    slots, h, r = 7, 2, 4
    pool, table, lengths, q, cur = _paged_case(slots, h, r, page, mp, seed=page + mp)
    n6, n7 = tpa.paged_decode_attend_cur.launches, tpa.paged_decode_attend.launches
    out6 = tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur)
    out7 = tpa.paged_decode_attend(*pool, table, lengths, q)
    torch.cuda.synchronize()
    assert (tpa.paged_decode_attend_cur.launches, tpa.paged_decode_attend.launches) == (n6 + 1,
                                                                                        n7 + 1)
    torch.testing.assert_close(out6, tpa.paged_decode_attend_cur_ref(*pool, table, lengths, q,
                                                                     *cur),
                               rtol=0, atol=_ATTN_ATOL)
    torch.testing.assert_close(out7, tpa.paged_decode_attend_ref(*pool, table, lengths, q),
                               rtol=0, atol=_ATTN_ATOL)
    assert torch.all(out7[0] == 0)  # length 0, no current column
    kc, ks = tpa._gather_dense_batch(pool[0], pool[1], table)
    vc, vs = tpa._gather_dense_batch(pool[2], pool[3], table)
    g = slots * h
    bound = lengths[:, None].expand(slots, h).reshape(g).contiguous()
    q3 = q.reshape(g, r, 128)
    flat = [t.reshape(g, *t.shape[2:]) for t in cur]
    dense6 = tda.decode_attend_q8kv_cur(kc, ks, vc, vs, q3, bound, *flat)
    dense7 = tda.decode_attend_q8kv(kc, ks, vc, vs, q3, bound)
    assert torch.equal(out6.reshape(g, r, 128), dense6)
    assert torch.equal(out7.reshape(g, r, 128), dense7)


def test_results_do_not_depend_on_the_batch(cuda):
    """A group's result is the same in a batch of many groups and alone:
    K4b over a dense cache and K6 over a pool (one slot's table row)."""
    base, cur = _attn_case(12, 5000, 128, 4, seed=95)
    bound = torch.arange(12, dtype=torch.int32, device=cuda) * 417
    full = tda.decode_attend_q8kv_cur(*base, bound, *cur)
    for i in (0, 5, 11):
        one = tda.decode_attend_q8kv_cur(*(t[i:i + 1] for t in base), bound[i:i + 1],
                                         *(t[i:i + 1] for t in cur))
        assert torch.equal(one[0], full[i])
    pool, table, lengths, q, cur = _paged_case(6, 2, 4, 16, 320, seed=96)
    full = tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur)
    for i in (1, 4):
        one = tpa.paged_decode_attend_cur(*pool, table[i:i + 1], lengths[i:i + 1], q[i:i + 1],
                                          *(t[i:i + 1] for t in cur))
        assert torch.equal(one[0], full[i])


def _append_cur(base, cur, bound):
    """The cache with row b of group i holding group i's current row."""
    kc, ks, vc, vs, q = base
    out = [t.clone() for t in (kc, ks, vc, vs)]
    for i, b in enumerate(bound.tolist()):
        for t, c in zip(out, cur):
            t[i, b] = c[i]
    return (*out, q)


def _slice_edges(s):
    """Visible counts n at the edges of the cluster regime's slices at cache
    length s: for slices of 16, 64 and 80 positions and the longest slice,
    n = C x slice - 1, C x slice and C x slice + 1 (the last block one short,
    every block full, and one position more, which widens every slice),
    each within 1..s."""
    c = tda._plan(s)[0]
    lens = sorted({16, 64, 80, tda.slice_len(s, c)})
    return sorted({n for l in lens for n in (c * l - 1, c * l, c * l + 1) if 1 <= n <= s})


@pytest.mark.parametrize("s", [2049, 8193])  # below and past the hand-over at 4096
def test_cluster_slice_edges_cur_equals_append_then_attend(cuda, s):
    """K4a(b) = K5a(b + 1) and K4b(b) = K5b(b + 1) bit for bit where the
    visible count n = b + 1 sits at a slice edge: the current row lands in
    the block, tile and lane that cache row b would; both within the twins'
    tolerance."""
    ns = _slice_edges(s)
    base, cur = _attn_case(len(ns), s, 128, 4, seed=100 + s)
    bound = torch.tensor([n - 1 for n in ns], dtype=torch.int32, device=cuda)
    appended = _append_cur(base, cur, bound)
    cur_fn, fn = ((tda.decode_attend_q8kv_cur, tda.decode_attend_q8kv) if s <= 4096 else
                  (tda.decode_attend_q8kv_blocked_cur, tda.decode_attend_q8kv_blocked))
    a = cur_fn(*base, bound, *cur)
    b = fn(*appended, bound + 1)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, tda.decode_attend_q8kv_cur_ref(*base, bound, *cur),
                               rtol=0, atol=_ATTN_ATOL)


@pytest.mark.parametrize("r,d", [(3, 100), (8, 48), (1, 36)])
def test_cluster_kernel_four_byte_copies_match_twins(cuda, r, d):
    """Rows of D % 16 != 0 bytes (and a cache that starts off a 16-byte
    boundary) take 4-byte copies; the result matches the twins."""
    s = 700
    base, cur = _attn_case(5, s, d, r, seed=110 + d)
    if d % 16 == 0:  # 16-byte rows, but the cache starts 4 bytes past a 16-byte boundary
        flat = torch.empty(base[0].numel() + 4, dtype=torch.int8, device=cuda)
        shifted = flat[4:].view(base[0].shape)
        shifted.copy_(base[0])
        base = (shifted, *base[1:])
    bound = torch.tensor([0, 1, 63, 64, s], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(tda.decode_attend_q8kv(*base, bound),
                               tda.decode_attend_q8kv_ref(*base, bound), rtol=0, atol=_ATTN_ATOL)
    torch.testing.assert_close(tda.decode_attend_q8kv_cur(*base, bound, *cur),
                               tda.decode_attend_q8kv_cur_ref(*base, bound, *cur),
                               rtol=0, atol=_ATTN_ATOL)


def test_results_do_not_depend_on_the_batch_in_small_caches(cuda):
    """A group alone equals the same group in a batch at S <= 4096 too
    (clusters of 8): K4a over a dense cache, K6 over a pool of pages of 16."""
    base, cur = _attn_case(12, 2048, 128, 4, seed=120)
    bound = torch.arange(12, dtype=torch.int32, device=cuda) * 186
    full = tda.decode_attend_q8kv_cur(*base, bound, *cur)
    for i in (0, 5, 11):
        one = tda.decode_attend_q8kv_cur(*(t[i:i + 1] for t in base), bound[i:i + 1],
                                         *(t[i:i + 1] for t in cur))
        assert torch.equal(one[0], full[i])
    pool, table, lengths, q, cur = _paged_case(6, 2, 4, 16, 128, seed=121)
    full = tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur)
    for i in (1, 4, 5):
        one = tpa.paged_decode_attend_cur(*pool, table[i:i + 1], lengths[i:i + 1], q[i:i + 1],
                                          *(t[i:i + 1] for t in cur))
        assert torch.equal(one[0], full[i])


def test_two_calls_give_the_same_bits(cuda):
    """No float atomics and a fixed order of every sum: K4a, K4b and K6
    repeat bit for bit."""
    for s in (2048, 8192):
        base, cur = _attn_case(6, s, 128, 4, seed=130 + s)
        bound = torch.tensor([0, 1, 17, s // 3, s - 1, s], dtype=torch.int32, device=cuda)
        fn = tda.decode_attend_q8kv_cur if s <= 4096 else tda.decode_attend_q8kv_blocked_cur
        assert torch.equal(fn(*base, bound, *cur), fn(*base, bound, *cur))
    pool, table, lengths, q, cur = _paged_case(5, 2, 4, 16, 512, seed=132)
    assert torch.equal(tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur),
                       tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur))


def test_paged_equals_dense_at_the_serving_context(cuda):
    """K6 and K7 at S = 8192 over pages of 16 (the paged loop's geometry)
    equal the dense kernels over the gathered view bit for bit."""
    slots, h, r = 4, 2, 4
    pool, table, lengths, q, cur = _paged_case(slots, h, r, 16, 512, seed=140)
    out6 = tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur)
    out7 = tpa.paged_decode_attend(*pool, table, lengths, q)
    kc, ks = tpa._gather_dense_batch(pool[0], pool[1], table)
    vc, vs = tpa._gather_dense_batch(pool[2], pool[3], table)
    g = slots * h
    bound = lengths[:, None].expand(slots, h).reshape(g).contiguous()
    q3 = q.reshape(g, r, 128)
    flat = [t.reshape(g, *t.shape[2:]) for t in cur]
    assert torch.equal(out6.reshape(g, r, 128), tda.decode_attend_q8kv_cur(kc, ks, vc, vs, q3,
                                                                           bound, *flat))
    assert torch.equal(out7.reshape(g, r, 128), tda.decode_attend_q8kv(kc, ks, vc, vs, q3, bound))
    torch.testing.assert_close(out6, tpa.paged_decode_attend_cur_ref(*pool, table, lengths, q,
                                                                     *cur),
                               rtol=0, atol=_ATTN_ATOL)


def test_paged_small_pages_stage_the_table_slice(cuda):
    """Pages of 4 make a slot's table row longer than a block keeps: each
    block then reads only its slice's entries. K6 and K7 still equal the
    dense kernels over the gathered view bit for bit, and their twins."""
    slots, h, r, page, mp = 5, 2, 4, 4, 300
    assert mp > tda._plan(page * mp)[1] + 2  # the slice path, not the whole row
    pool, table, lengths, q, cur = _paged_case(slots, h, r, page, mp, seed=145)
    out6 = tpa.paged_decode_attend_cur(*pool, table, lengths, q, *cur)
    out7 = tpa.paged_decode_attend(*pool, table, lengths, q)
    kc, ks = tpa._gather_dense_batch(pool[0], pool[1], table)
    vc, vs = tpa._gather_dense_batch(pool[2], pool[3], table)
    g = slots * h
    bound = lengths[:, None].expand(slots, h).reshape(g).contiguous()
    q3 = q.reshape(g, r, 128)
    flat = [t.reshape(g, *t.shape[2:]) for t in cur]
    assert torch.equal(out6.reshape(g, r, 128), tda.decode_attend_q8kv_cur(kc, ks, vc, vs, q3,
                                                                           bound, *flat))
    assert torch.equal(out7.reshape(g, r, 128), tda.decode_attend_q8kv(kc, ks, vc, vs, q3, bound))
    torch.testing.assert_close(out7, tpa.paged_decode_attend_ref(*pool, table, lengths, q),
                               rtol=0, atol=_ATTN_ATOL)


def test_split_regime_past_the_cluster_capacity(cuda):
    """Past S = 16384 the kernels run the split regime (three launches
    over a scratch): K5b and K4b against their twins, K4b(b) = K5b(b + 1)."""
    s = tda._MAX_CLUSTER_S + 16
    assert tda._plan(s) == (0, 0)
    base, cur = _attn_case(3, s + 1, 128, 4, seed=150)
    bound = torch.tensor([1, 513, s], dtype=torch.int32, device=cuda)
    n5, n4 = tda.decode_attend_q8kv_blocked.launches, tda.decode_attend_q8kv_blocked_cur.launches
    out5 = tda.decode_attend_q8kv(*base, bound)
    out4 = tda.decode_attend_q8kv_cur(*base, bound, *cur)
    torch.cuda.synchronize()
    assert (tda.decode_attend_q8kv_blocked.launches,
            tda.decode_attend_q8kv_blocked_cur.launches) == (n5 + 1, n4 + 1)
    torch.testing.assert_close(out5, tda.decode_attend_q8kv_ref(*base, bound),
                               rtol=0, atol=_ATTN_ATOL)
    torch.testing.assert_close(out4, tda.decode_attend_q8kv_cur_ref(*base, bound, *cur),
                               rtol=0, atol=_ATTN_ATOL)
    assert torch.equal(out4, tda.decode_attend_q8kv(*_append_cur(base, cur, bound), bound + 1))


@pytest.mark.parametrize("r", [1, 4, 8])
def test_cluster_regime_fits_on_the_card(cuda, r):
    """At every S of the cluster regime's plan the card holds clusters of
    the kernel at once (a launch that cannot be placed is refused)."""
    for s in (1, 2048, 4096, 8192, tda._MAX_CLUSTER_S):
        assert tda.cluster_occupancy(r, s) >= 1


# (M, K, N, s_x, zp, qmin, qmax): ResNet-18's fc call, ragged edges with
# zp != 0, the A4 range, and a shape of many blocks
_K1_CASES = [
    (512, 512, 10, 0.05, 0.0, -128.0, 127.0),
    (33, 200, 19, 0.0625, 3.0, -128.0, 127.0),
    (17, 64, 130, 0.5, -2.0, -8.0, 7.0),
    (1000, 1024, 300, 0.02, 0.0, -128.0, 127.0),
]


@pytest.mark.parametrize("m,k,n,s_x,zp,qmin,qmax", _K1_CASES)
def test_int8_matmul_dequant_kernel_equals_twin_bit_for_bit(cuda, m, k, n, s_x, zp, qmin, qmax):
    gen = _gen(m + k)
    x = torch.randn((m, k), device=cuda, generator=gen) * (40 * s_x)
    # a quarter of x on .5 code boundaries
    ties = (torch.randint(-20, 20, (m, k), device=cuda, generator=gen) + 0.5) * s_x
    x = torch.where(torch.rand((m, k), device=cuda, generator=gen) < 0.25, ties, x)
    w_q = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=cuda, generator=gen)
    w_scale = torch.rand((n,), device=cuda, generator=gen) * 0.02 + 1e-3
    s, z = torch.tensor(s_x, device=cuda), torch.tensor(zp, device=cuda)
    before = ti8.int8_matmul_dequant.launches
    out = ti8.int8_matmul_dequant(x, w_q, w_scale, s, z, qmin, qmax)
    torch.cuda.synchronize()
    assert ti8.int8_matmul_dequant.launches == before + 1
    assert torch.equal(out, ti8.int8_matmul_dequant_ref(x, w_q, w_scale, s, z, qmin, qmax))


def test_int8_matmul_dequant_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn((4, 16), device=cuda)
    with pytest.raises(ValueError):  # int8 weights on the CPU
        ti8.int8_matmul_dequant(x, torch.zeros((16, 8), dtype=torch.int8), torch.ones(8, device=cuda),
                                1.0, 0.0)


def _k1_inputs(m, k, n, s_x, zp, seed):
    gen = _gen(seed)
    x = torch.randn((m, k), device="cuda", generator=gen) * (40 * s_x)
    ties = (torch.randint(-20, 20, (m, k), device="cuda", generator=gen) + 0.5) * s_x
    x = torch.where(torch.rand((m, k), device="cuda", generator=gen) < 0.25, ties, x)
    w_q = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
    w_scale = torch.rand((n,), device="cuda", generator=gen) * 0.02 + 1e-3
    return x, w_q, w_scale, torch.tensor(s_x, device="cuda"), torch.tensor(zp, device="cuda")


# beyond _K1_CASES: M = 1, K not a multiple of 16 or 32, N = 10, zp != 0, and an A4 call of
# the GEMM regime's size with a ragged K and an odd N
_K1_REGIME_CASES = _K1_CASES + [
    (1, 37, 10, 0.05, 0.0, -128.0, 127.0),
    (7, 100, 10, 0.1, 2.0, -128.0, 127.0),
    (300, 1000, 513, 0.25, -3.0, -8.0, 7.0),
    (129, 2000, 130, 0.05, 1.0, -128.0, 127.0),
]



@pytest.mark.parametrize("m,k,n,s_x,zp,qmin,qmax", _K1_REGIME_CASES)
def test_int8_matmul_dequant_regimes_equal_twin_bit_for_bit(cuda, m, k, n, s_x, zp, qmin, qmax):
    """K1 forced into each regime (the small mma.sync kernel, the wgmma
    GEMM with its pre-passes; N % 4 == 0 stores out by TMA, other N by
    plain stores): each equals the twin and the other bit for bit, a second
    call equals the first, and neither counts a launch."""
    x, w_q, w_scale, s, z = _k1_inputs(m, k, n, s_x, zp, seed=m + k + n)
    ref = ti8.int8_matmul_dequant_ref(x, w_q, w_scale, s, z, qmin, qmax)
    before = ti8.int8_matmul_dequant.launches
    quant = (s, z, qmin, qmax)
    small = ti8._small_call(x, w_q, w_scale, quant)
    torch.cuda.synchronize()
    assert torch.equal(small, ref)
    assert torch.equal(ti8._small_call(x, w_q, w_scale, quant), small)
    gemm = ti8._gemm_call(x, w_q, w_scale, quant)
    torch.cuda.synchronize()
    assert torch.equal(gemm, ref)
    assert torch.equal(ti8._gemm_call(x, w_q, w_scale, quant), gemm)
    assert ti8.int8_matmul_dequant.launches == before


def test_int8_matmuls_count_one_launch_per_wrapper_call(cuda):
    """Each public call counts one launch, in either regime, pre-passes
    included; the twin on CPU tensors counts none."""
    for m, k, n in [(512, 512, 10), (1024, 1024, 1024)]:
        x, w_q, w_scale, s, z = _k1_inputs(m, k, n, 0.05, 0.0, seed=3)
        b1, b2 = ti8.int8_matmul_dequant.launches, ti8.binary_act_matmul.launches
        ti8.int8_matmul_dequant(x, w_q, w_scale, s, z)
        ti8.binary_act_matmul(x, w_q.clamp(-1, 1), w_scale)
        ti8.int8_matmul_dequant(x.cpu(), w_q.cpu(), w_scale.cpu(), 0.05, 0.0)
        torch.cuda.synchronize()
        assert ti8.int8_matmul_dequant.launches == b1 + 1
        assert ti8.binary_act_matmul.launches == b2 + 1


def test_int8_matmuls_raise_past_their_limits(cuda):
    """K past the int32 bound, and an empty x, raise in both regimes and in
    the public wrappers, before anything launches."""
    k = ti8._K_MAX + 1
    x = torch.randn((1, k), device=cuda)
    w_q = torch.zeros((k, 10), dtype=torch.int8, device=cuda)
    ones = torch.ones(10, device=cuda)
    quant = (torch.tensor(1.0, device=cuda), torch.tensor(0.0, device=cuda), -128.0, 127.0)
    for call in (ti8._small_call, ti8._gemm_call):
        with pytest.raises(ValueError, match="int32"):
            call(x, w_q, ones, quant)
        with pytest.raises(ValueError, match="int32"):
            call(x, w_q, ones)
        with pytest.raises(ValueError, match="M, K, N > 0"):
            call(x[:0], w_q, ones)
    before = ti8.binary_act_matmul.launches
    with pytest.raises(ValueError, match="int32"):
        ti8.binary_act_matmul(x, w_q, ones)
    with pytest.raises(ValueError, match="int32"):
        ti8.int8_matmul_dequant(x, w_q, ones, 1.0, 0.0)
    assert ti8.binary_act_matmul.launches == before
    # the largest K takes both regimes
    k = ti8._K_MAX
    x = torch.full((1, k), -1.0, device=cuda)
    w_q = torch.full((k, 10), -128, dtype=torch.int8, device=cuda)
    ref = ti8.int8_matmul_dequant_ref(x, w_q, ones, 1.0 / 128, 0.0)
    assert ref[0, 0].item() == k * 128  # acc = K * 128 * 128, times 1 / 128
    for call in (ti8._small_call, ti8._gemm_call):
        assert torch.equal(call(x, w_q, ones, (torch.tensor(1.0 / 128, device=cuda),
                                                torch.tensor(0.0, device=cuda), -128.0, 127.0)),
                           ref)


# ResNet-18 and NIN-GC layer shapes at batch 4 (see tests/test_torch_engine.py)
_CONV_CASES = [
    (4, 64, 32, 64, 3, 1, 1, 1, False),
    (4, 64, 32, 128, 3, 2, 1, 1, False),
    (4, 64, 32, 128, 1, 2, 0, 1, False),
    (4, 512, 4, 512, 3, 1, 1, 1, False),
    (1, 512, 4, 512, 3, 1, 1, 1, False),
    (4, 256, 16, 512, 3, 1, 1, 16, True),
    (4, 512, 8, 1024, 3, 1, 1, 32, True),
    (4, 1024, 8, 10, 1, 1, 0, 1, True),
]


@pytest.mark.parametrize("n,cin,size,co,k,s,p,groups,w4", _CONV_CASES)
def test_int_conv_card_route_exact(cuda, n, cin, size, co, k, s, p, groups, w4):
    """im2col + ``torch._int_mm`` on the card: the int32 accumulator
    equals an f64 convolution of the same codes."""
    from micronet_tpu_torch.infer.engine import IntConv2d, _maybe_pack_w4

    gen = _gen(cin + co)
    lim = 8 if w4 else 128
    w = torch.randint(1 - lim, lim, (co, cin // groups, k, k), dtype=torch.int8, device=cuda,
                      generator=gen)
    x = torch.randint(-lim, lim, (n, cin, size, size), dtype=torch.int8, device=cuda,
                      generator=gen)
    conv = IntConv2d(w, torch.ones(co, device=cuda), torch.tensor(1.0), None, (s, s), (p, p),
                     (1, 1), groups, -lim, lim - 1)
    if w4:
        _maybe_pack_w4(conv, conv._weights_hwio().reshape(-1, co))
    acc = conv.int_acc(x)
    ref = torch.nn.functional.conv2d(x.cpu().double(), w.cpu().double(), None, s, p, 1, groups)
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu().double(), ref)


def test_first_layer_route_is_full_f32(cuda):
    """The image-input layer convolves dequantized values with TF32 off
    inside the call, even when the caller left TF32 on."""
    from micronet_tpu_torch.infer.engine import IntConv2d

    gen = _gen(3)
    w = torch.randint(-127, 128, (64, 3, 3, 3), dtype=torch.int8, device=cuda, generator=gen)
    conv = IntConv2d(w, torch.rand(64, device=cuda, generator=gen) * 0.01, torch.tensor(0.03),
                     None, (1, 1), (1, 1), (1, 1), 1, -128.0, 127.0).to(cuda)
    assert conv.f32_dequant
    x = torch.randint(-128, 128, (8, 3, 32, 32), dtype=torch.int8, device=cuda, generator=gen)
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = conv.dequant_conv(x)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    xd = x.double() * conv.act_scale.double()
    wd = w.double() * conv.w_scale.double()[:, None, None, None]
    ref = torch.nn.functional.conv2d(xd, wd, None, 1, 1)
    # f32 sums of 27 terms: ~1e-6 relative; TF32 operands would miss by ~1e-3
    torch.testing.assert_close(out.double(), ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def test_small_resnet_engine_on_card_matches_cpu(cuda):
    """A small W8A8 ResNet through the whole flow on the card, then the same
    engine on the CPU (the wrappers' twins, f64 convs): K1 launches once
    per forward and the logits agree."""
    import copy

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models.resnet import BasicBlock, ResNet
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = _gen(11)
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)
    q = prepare(ResNet(BasicBlock, [1, 1, 1, 1], device=cuda, generator=gen), cfg, device=cuda)
    train_mode(q)
    with torch.no_grad():
        for _ in range(3):
            q(torch.randn((16, 32, 32, 3), device=cuda, generator=gen))
    fused = fuse_bn_iao(eval_mode(q), cfg, device=cuda)
    x = torch.randn((8, 32, 32, 3), device=cuda, generator=gen)
    eng = eval_mode(freeze_int(eval_mode(fused), example_input=x[:1], device=cuda))
    assert any(getattr(m, "chained", False) for m in eng.modules())
    before = ti8.int8_matmul_dequant.launches
    with torch.no_grad():
        out = eng(x)
        torch.cuda.synchronize()
        assert ti8.int8_matmul_dequant.launches == before + 1
        ref = copy.deepcopy(eng).to("cpu")(x.cpu())
    # the first layer's f32 sums run in another order on the card: a code
    # there can move one step, damped by the layers after it
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=2e-2 * max(1.0, ref.abs().max().item()))


# (cin, cout, k, stride, padding, output_padding, dilation, groups): UpNet's
# upsampler, output_padding 1, groups 4, dilation 2, padding past d (k - 1)
_CONVT_CASES = [(16, 8, 4, 2, 1, 0, 1, 1), (8, 6, 3, 2, 1, 1, 1, 1), (8, 12, 3, 2, 0, 0, 1, 4),
                (6, 4, 3, 1, 2, 0, 2, 1), (6, 6, 3, 2, 3, 1, 1, 2)]


@pytest.mark.parametrize("case", _CONVT_CASES)
def test_int_conv_transpose_card_route_exact(cuda, case):
    """The transposed conv on the card (the dilated, padded or cropped
    input through im2col + ``torch._int_mm``) and its window sums equal
    f64 ``conv_transpose2d``s of the same codes."""
    from micronet_tpu_torch.infer.engine import IntConvTranspose2d

    cin, co, k, s, p, op, d, g = case
    gen = _gen(cin + co + k)
    w = torch.randint(-128, 128, (cin, co // g, k, k), dtype=torch.int8, device=cuda,
                      generator=gen)
    x = torch.randint(-128, 128, (3, cin, 7, 5), dtype=torch.int8, device=cuda, generator=gen)
    layer = IntConvTranspose2d(w, 1.0, 1.0, 0.0, None, (s, s), (p, p), (op, op), (d, d), g,
                               -128.0, 127.0)
    acc, sums = layer.int_acc(x, group_sums=True)
    ref = torch.nn.functional.conv_transpose2d(x.cpu().double(), w.cpu().double(), None, s, p,
                                               op, g, d)
    ones = torch.ones((cin, 1, k, k), dtype=torch.float64)
    ref_sums = torch.nn.functional.conv_transpose2d(x.cpu().double(), ones, None, s, p, op, g, d)
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu().double(), ref)
    assert torch.equal(sums.cpu().double(), ref_sums)


def _asym_engine(build, cfg, x, gen, cuda):
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode

    q = train_mode(prepare(build(), cfg, device=cuda))
    with torch.no_grad():
        for _ in range(3):
            q(torch.randn(x.shape, device=cuda, generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=cuda))
    return fused, eval_mode(freeze_int(fused, example_input=x[:1], device=cuda))


@pytest.mark.parametrize("net", ["nin_gc", "resnet"])
def test_asym_engine_on_card_equals_cpu_bit_for_bit(cuda, net):
    """The asymmetric W4A4 recipe with 8-bit first and last layers on a
    narrow NIN-GC and a small ResNet: the card's engine (the correction
    terms from the patch matrix and one image of ones) equals the same
    engine on the CPU (f64 convolutions) bit for bit, and launches no
    hand-written kernel (the ResNet's fc is an asymmetric ``IntLinear``
    on ``torch._int_mm``)."""
    import copy

    from micronet_tpu_torch.models import nin_gc
    from micronet_tpu_torch.models.resnet import BasicBlock, ResNet
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = _gen(21)
    cfg = QuantConfig(a_bits=4, w_bits=4, q_type=1, bn_fuse=True, first_layer_a_bits=8,
                      first_layer_w_bits=8, last_layer_a_bits=8, last_layer_w_bits=8)
    build = {"nin_gc": lambda: nin_gc.Net(cfg=[64] * 8, device=cuda, generator=gen),
             "resnet": lambda: ResNet(BasicBlock, [1, 1, 1, 1], device=cuda, generator=gen)}
    x = torch.randn((8, 32, 32, 3), device=cuda, generator=gen)
    _, eng = _asym_engine(build[net], cfg, x, gen, cuda)
    before = ti8.int8_matmul_dequant.launches
    with torch.no_grad():
        out = eng(x)
        torch.cuda.synchronize()
        assert ti8.int8_matmul_dequant.launches == before
        ref = copy.deepcopy(eng).to("cpu")(x.cpu())
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("q_type", [0, 1])
def test_upnet_and_concat_engines_on_card_equal_cpu(cuda, q_type):
    """A conv, a stride-2 transposed conv and a 1x1 conv, and two 1x1
    convs into a concat (chained when symmetric): the card's engine equals
    the CPU's bit for bit."""
    import copy

    from micronet_tpu_torch.nn import modules as M
    from micronet_tpu_torch.quant.config import QuantConfig

    class UpCat(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = M.Conv2d(8, 16, 3, padding=1, device=cuda, generator=gen)
            self.up = M.ConvTranspose2d(16, 8, 4, stride=2, padding=1, device=cuda,
                                        generator=gen)
            self.a = M.Conv2d(8, 8, 1, device=cuda, generator=gen)
            self.b = M.Conv2d(8, 8, 1, device=cuda, generator=gen)
            self.cat = M.Concat(-1)
            self.c3 = M.Conv2d(16, 4, 1, device=cuda, generator=gen)

        def forward(self, x):
            h = self.up(self.c1(x.permute(0, 3, 1, 2)))
            return self.c3(self.cat(self.a(h), self.b(h)))

    gen = _gen(22)
    x = torch.randn((4, 16, 16, 8), device=cuda, generator=gen)
    _, eng = _asym_engine(UpCat, QuantConfig(q_type=q_type), x, gen, cuda)
    # symmetric: a and b into the concat, the concat into c3
    assert sum(getattr(m, "chained", False) for m in eng.modules()) == (3 if q_type == 0 else 0)
    with torch.no_grad():
        out = eng(x)
        ref = copy.deepcopy(eng).to("cpu")(x.cpu())
    assert torch.equal(out.cpu(), ref)


# K2 calls: the engine's largest 1x1 conv as a GEMM at a small batch, a
# ragged call with K % 128 != 0, and one of many row blocks
_K2_CASES = [(1024, 1024, 1024), (333, 200, 19), (5, 37, 10), (2000, 256, 130)]


@pytest.mark.parametrize("m,k,n", _K2_CASES)
def test_binary_act_matmul_kernel_equals_twin_bit_for_bit(cuda, m, k, n):
    """K2 against its twin: exact int32 sums, one rounded multiply; x holds
    exact zeros, -0.0 (both +1) and NaN (-1)."""
    gen = _gen(m + n)
    x = torch.randn((m, k), device=cuda, generator=gen)
    x = torch.where(torch.rand((m, k), device=cuda, generator=gen) < 0.1, 0.0, x)
    x = torch.where(torch.rand((m, k), device=cuda, generator=gen) < 0.1, -0.0, x)
    x[0, 0] = float("nan")
    w_q = torch.randint(-1, 2, (k, n), dtype=torch.int8, device=cuda, generator=gen)
    alpha = torch.rand((n,), device=cuda, generator=gen) + 0.5
    before = ti8.binary_act_matmul.launches
    out = ti8.binary_act_matmul(x, w_q, alpha)
    torch.cuda.synchronize()
    assert ti8.binary_act_matmul.launches == before + 1
    assert torch.equal(out, ti8.binary_act_matmul_ref(x, w_q, alpha))


def test_binary_act_matmul_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn((4, 16), device=cuda)
    with pytest.raises(ValueError):  # int32 weights
        ti8.binary_act_matmul(x, torch.zeros((16, 8), dtype=torch.int32, device=cuda),
                              torch.ones(8, device=cuda))
    with pytest.raises(ValueError):  # f16 activations
        ti8.binary_act_matmul(x.half(), torch.zeros((16, 8), dtype=torch.int8, device=cuda),
                              torch.ones(8, device=cuda))


_K2_REGIME_CASES = _K2_CASES + [(1, 45, 10), (64, 1000, 300), (40, 1500, 260)]


@pytest.mark.parametrize("m,k,n", _K2_REGIME_CASES)
def test_binary_act_matmul_regimes_equal_twin_bit_for_bit(cuda, m, k, n):
    """K2 forced into each regime, x holding 0, -0.0 (both +1) and NaN
    (-1): each equals the twin and the other bit for bit, and a second call
    equals the first."""
    gen = _gen(7 * m + n)
    x = torch.randn((m, k), device=cuda, generator=gen)
    x = torch.where(torch.rand((m, k), device=cuda, generator=gen) < 0.1, 0.0, x)
    x = torch.where(torch.rand((m, k), device=cuda, generator=gen) < 0.1, -0.0, x)
    x[0, 0] = float("nan")
    w_q = torch.randint(-1, 2, (k, n), dtype=torch.int8, device=cuda, generator=gen)
    alpha = torch.rand((n,), device=cuda, generator=gen) + 0.5
    ref = ti8.binary_act_matmul_ref(x, w_q, alpha)
    before = ti8.binary_act_matmul.launches
    small = ti8._small_call(x, w_q, alpha)
    torch.cuda.synchronize()
    assert torch.equal(small, ref)
    assert torch.equal(ti8._small_call(x, w_q, alpha), small)
    gemm = ti8._gemm_call(x, w_q, alpha)
    torch.cuda.synchronize()
    assert torch.equal(gemm, ref)
    assert torch.equal(ti8._gemm_call(x, w_q, alpha), gemm)
    assert ti8.binary_act_matmul.launches == before


# (K, N, K9's group): the 8B wo shape; K/2 = 320 (five 64-row stages) with a ragged N;
# K/2 not a multiple of 16 with N = 4 and with N = 4000 (ragged column tile, 16-byte rows);
# K/2 odd (x copied 4 bytes at a time) with N = 12; groups of 16, 32, 64, 128 (a k-tile in
# one group) and 20, 50, 11 (groups crossing k-tiles)
_W4_SHAPES = [(4096, 4096, 128), (640, 100, 64), (14336, 512, 128), (200, 4, 20),
              (1000, 4000, 50), (198, 12, 11), (2560, 256, 32), (512, 64, 16)]


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 16, 33, 128])
@pytest.mark.parametrize("k,n,g", _W4_SHAPES)
def test_int4_plain_kernels_match_twins(cuda, m, k, n, g):
    """K8 (per-column scales) and K9 (group ``g``) against their twins
    within K3's bound (exact products, f32 sums in another order); the
    first, a middle and the last row alone equal the same rows of the
    batch bit for bit, and a second call equals the first."""
    gen = _gen(m + k + n)
    w = torch.randn((k, n), device=cuda, generator=gen) * 0.05
    x = torch.randn((m, k), device=cuda, generator=gen)
    w_q, scale = tim.quantize_int4_weight(w)
    wg_q, gs = tim.quantize_int4_weight_grouped(w, g)
    for fn, twin, packed, s in ((tim.int4_matmul, tim.int4_matmul_ref, tim.pack_int4(w_q), scale),
                                (tim.int4_matmul_grouped, tim.int4_matmul_grouped_ref,
                                 tim.pack_int4(wg_q), gs)):
        before = fn.launches
        out = fn(x, packed, s)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = twin(x, packed, s)
        torch.testing.assert_close(out, ref, rtol=0, atol=2e-5 * ref.abs().max().item())
        for r in sorted({0, m // 2, m - 1}):
            assert torch.equal(fn(x[r:r + 1].contiguous(), packed, s)[0], out[r])
        assert torch.equal(fn(x, packed, s), out)


def test_int4_plain_kernels_reject_what_they_cannot_take(cuda):
    x = torch.randn((2, 96), device=cuda)
    packed = torch.zeros((48, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="must divide K/2"):  # 32 does not divide 48
        tim.int4_matmul_grouped(x, packed, torch.ones((3, 8), device=cuda))
    with pytest.raises(ValueError):  # N % 4 != 0
        tim.int4_matmul(x, torch.zeros((48, 6), dtype=torch.int8, device=cuda),
                        torch.ones(6, device=cuda))
    with pytest.raises(ValueError):  # bf16 activations
        tim.int4_matmul(x.bfloat16(), packed, torch.ones(8, device=cuda))


# NIN-GC's seven ternary convs at default widths (cin, size, cout, k, pad, groups)
_TERNARY_CASES = [(256, 32, 256, 1, 0, 2), (256, 32, 256, 1, 0, 2), (256, 16, 512, 3, 1, 16),
                  (512, 16, 512, 1, 0, 4), (512, 16, 512, 1, 0, 4), (512, 8, 1024, 3, 1, 32),
                  (1024, 8, 1024, 1, 0, 8)]


@pytest.mark.parametrize("cin,size,cout,k,pad,groups", _TERNARY_CASES)
def test_ternary_conv_card_route_exact(cuda, cin, size, cout, k, pad, groups):
    """The wbwtab engine's conv on the card (im2col over the int8 signs,
    ``torch._int_mm``) equals an f64 conv of the same signs bit for bit,
    and its output equals the CPU engine's."""
    from micronet_tpu_torch.infer.engine import TernaryConv2d

    gen = _gen(cin + cout + k)
    w_t = torch.randint(-1, 2, (cout, cin // groups, k, k), dtype=torch.int8, device=cuda,
                        generator=gen)
    alpha = torch.rand((cout,), device=cuda, generator=gen) + 0.1
    bias = torch.randn((cout,), device=cuda, generator=gen)
    conv = TernaryConv2d(w_t, alpha, bias, (1, 1), (pad, pad), (1, 1), groups)
    x = torch.where(torch.randn((4, cin, size, size), device=cuda, generator=gen) >= 0, 1.0, -1.0)
    acc = conv.int_acc(x.to(torch.int8))
    ref = torch.nn.functional.conv2d(x.cpu().double(), w_t.cpu().double(), None, 1, pad, 1, groups)
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu().double(), ref)
    cpu = TernaryConv2d(w_t.cpu(), alpha.cpu(), bias.cpu(), (1, 1), (pad, pad), (1, 1), groups)
    assert torch.equal(conv(x).cpu(), cpu(x.cpu()))


# -------------------------------------------------- slice 5: training


def _smoke():
    """``chip_smoke.py`` at the repository's root, for its card-vs-CPU
    training-step check."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", ["float", "iao", "dorefa", "wbwtab"])
def test_train_step_on_card_equals_cpu(cuda, label):
    """One step of each method on NIN-GC (cfg 64) at batch 8, the card
    against the CPU block by block (``chip_smoke.step_card_vs_cpu``:
    losses within 1e-4 relative, gradients within 1e-4 x max|g|)."""
    cs = _smoke()
    flags = dict(cs.TRAIN_METHODS)[label]
    res = cs.step_card_vs_cpu(flags, 8, cuda, 0, cfg_widths=[64] * 8)
    assert res["blocks"] == 12 and res["loss_rel_diff"] <= 1e-4


def test_ptq_observers_on_card_equal_cpu(cuda):
    """The percentile (``torch.topk``) and entropy (``torch.bincount``)
    observers on the card: the percentile and absmax equal the CPU's, the
    counts within an f32 rounding of the rescale's sums (atomics add in
    any order)."""
    from micronet_tpu_torch.quant import observers as obs

    gen = torch.Generator().manual_seed(0)
    es, ec = obs.init_entropy_state(2048), obs.init_entropy_state(2048, device=cuda)
    for scale in (1.0, 4.0, 0.5, 9.0):
        x = torch.randn((64, 64, 32, 32), generator=gen) * scale
        assert float(obs.percentile_absmax(x.to(cuda), 0.9999)) == float(
            obs.percentile_absmax(x, 0.9999))
        es, ec = obs.entropy_update(es, x), obs.entropy_update(ec, x.to(cuda))
        assert float(ec.absmax) == float(es.absmax)
        torch.testing.assert_close(ec.counts.cpu(), es.counts, rtol=1e-6, atol=1e-3)


def test_trainer_fit_on_card_and_checkpoint_on_cpu(cuda, tmp_path):
    """``Trainer.fit`` on the card (LeNet, IAO with BN folding, 2 epochs,
    ``restore_best``); its checkpoint loads into the same model on the CPU
    with the same forward."""
    from micronet_tpu_torch.models.lenet import LeNet
    from micronet_tpu_torch.nn import eval_mode, prepare
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import TrainConfig, Trainer, data, load_state

    tx, ty, ex, ey = data._synthetic(256, 64)
    ds = data.Cifar10(tx, ty, ex, ey, source="synthetic")
    cfg = QuantConfig(bn_fuse=True)
    model = prepare(LeNet(device=cuda), cfg, device=cuda)
    tr = Trainer(model, TrainConfig(batch_size=32, epochs=2, log_every=0), dataset=ds,
                 device=cuda)
    tr.fit(checkpoint_path=str(tmp_path / "c.npz"), log=lambda s: None, restore_best=True)
    cpu = prepare(LeNet(device="cpu"), cfg, device="cpu")
    load_state(str(tmp_path / "c.npz"), cpu)
    x = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = eval_mode(model)(x.to(cuda)).cpu()
        got = eval_mode(cpu)(x)
    # restore_best: the model in memory is the saved best epoch's; a
    # fake-quant code at a .5 edge may round otherwise on the card
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2 * max(1.0, want.abs().max()))


def test_true_div_on_card_equals_cpu(cuda):
    """The quant path's divisions by a constant (``rounding.true_div``):
    bit for bit the CPU's true division on the card, where dividing by a
    Python number would multiply by its reciprocal."""
    from micronet_tpu_torch.quant.rounding import true_div
    from micronet_tpu_torch.quant.quantizers import symmetric_qparams

    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0)) * 10
    for c in (127.5, 255.0, 127.0, 1.0 / 255.0, 2048.0):
        assert torch.equal(true_div(x.to(cuda), c).cpu(), true_div(x, c))
    lo, hi = -x.abs()[:64].reshape(64, 1), x.abs()[64:128].reshape(64, 1)
    card = symmetric_qparams(lo.to(cuda), hi.to(cuda), -128.0, 127.0)[0].cpu()
    assert torch.equal(card, symmetric_qparams(lo, hi, -128.0, 127.0)[0])


# -------------------------------------------------- slice 7: TinyDecoder serving


# K3 at the W4 TinyDecoder's shapes (K, N) with a group dividing K/2: the self-test's
# K = 16 at group 8 (regime A for any M: 8 is not a multiple of 16), and the example's
# widths, K = 128 and 256 at groups 8 and 32 (K/2 = 64 or 128 packed rows: at most two of
# the decode regime's 64-row K units)
_DECODER_K3 = [(k, n, g) for k in (16, 128, 256) for n in (16, 128, 256) for g in (8, 32)
               if (k // 2) % g == 0]


@pytest.mark.parametrize("m", [1, 4, 7])
@pytest.mark.parametrize("k,n,g", _DECODER_K3)
def test_int4_hl8_kernel_at_decoder_shapes_matches_twin(cuda, m, k, n, g):
    gen = _gen(2000 + m + k + n + g)
    w = torch.randn((k, n), device=cuda, generator=gen) * 0.05
    w_q, gs = tim.quantize_int4_weight_grouped(w, g)
    packed = tim.pack_int4_hl8(w_q)
    x = torch.randn((m, k), device=cuda, generator=gen)
    before = tim.int4_matmul_grouped_hl8.launches
    out = tim.int4_matmul_grouped_hl8(x, packed, gs)
    torch.cuda.synchronize()
    assert tim.int4_matmul_grouped_hl8.launches == before + 1
    ref = tim.int4_matmul_grouped_hl8_ref(x, packed, gs)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5 * ref.abs().max().item())
    assert torch.equal(tim.int4_matmul_grouped_hl8(x, packed, gs), out)
    for r in sorted({0, m - 1}):  # regime A: a row alone is its batch's row, bit for bit
        assert torch.equal(tim.int4_matmul_grouped_hl8(x[r:r + 1].contiguous(), packed, gs)[0],
                           out[r])


# K3 at the column slices of tensor-parallel serving (shard_state over tp = 2 and 4): the
# W4 Llama-3-8B's fused QKV (N = 6,144 / tp), output (4,096 / tp), gate+up (28,672 / tp) and
# down (K = 14,336) projections at group 128, and its W4 lm_head (128,256 / tp: 32,064 is not
# a multiple of the 128-column tile); the W4 TinyDecoder's at group 32 (N = 64 and 32)
_TP_K3 = ([(4096, n, 128) for n in (3072, 1536, 2048, 1024, 14336, 7168, 64128, 32064)]
          + [(14336, n, 128) for n in (2048, 1024)]
          + [(k, n, 32) for k in (128, 256) for n in (64, 32)])


@pytest.mark.parametrize("m", [1, 8, 200])
@pytest.mark.parametrize("k,n,g", _TP_K3)
def test_int4_hl8_kernel_at_tensor_parallel_slices_matches_twin(cuda, m, k, n, g):
    """Decode (M = 1 and 8, regime A) and a prompt past 128 rows (regime B)
    at each slice, against the twin within 2e-5 x max|twin|; a column
    slice's own call against the same columns of the whole call within the
    same bound (regime A may take another K-split: the split count depends
    on N), and with ``split_cols`` the whole N (what ``shard_state`` sets)
    bit for bit."""
    gen = _gen(3000 + m + k + n + g)
    w = torch.randn((k, n * 2), device=cuda, generator=gen) * 0.05
    w_q, gs = tim.quantize_int4_weight_grouped(w, g)
    packed = tim.pack_int4_hl8(w_q)
    x = torch.randn((m, k), device=cuda, generator=gen)
    half, gs_half = packed[:, :n].contiguous(), gs[:, :n].contiguous()
    before = tim.int4_matmul_grouped_hl8.launches
    out = tim.int4_matmul_grouped_hl8(x, half, gs_half)
    whole = tim.int4_matmul_grouped_hl8(x, packed, gs)
    torch.cuda.synchronize()
    assert tim.int4_matmul_grouped_hl8.launches == before + 2
    ref = tim.int4_matmul_grouped_hl8_ref(x, half, gs_half)
    tol = 2e-5 * ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, whole[:, :n], rtol=0, atol=tol)
    assert torch.equal(tim.int4_matmul_grouped_hl8(x, half, gs_half), out)
    for cols in (slice(0, n), slice(n, 2 * n)):
        shard = tim.int4_matmul_grouped_hl8(x, packed[:, cols].contiguous(),
                                            gs[:, cols].contiguous(), split_cols=2 * n)
        assert torch.equal(shard, whole[:, cols])


def test_decode_attention_at_decoder_shape_matches_twin(cuda):
    """K5a at the TinyDecoder's decode attend: G = 8 heads, R = 1 (q as
    (G, D), what ``attend`` passes for MHA, and as (G, 1, D)), D = 16,
    S = 64, bounds 0..64 across slice edges of the 8-block cluster; K4a at
    bound b equals K5a at b + 1 bit for bit there too."""
    s, d = 64, 16
    base, cur = _attn_case(8, s, d, 1, seed=140)
    bound = torch.tensor([0, 1, 15, 16, 17, 33, s - 1, s], dtype=torch.int32, device=cuda)
    before = tda.decode_attend_q8kv.launches
    out3 = tda.decode_attend_q8kv(*base, bound)
    out2 = tda.decode_attend_q8kv(*base[:4], base[4][:, 0].contiguous(), bound)
    torch.cuda.synchronize()
    assert tda.decode_attend_q8kv.launches == before + 2
    assert out2.shape == (8, d) and torch.equal(out2, out3[:, 0])
    torch.testing.assert_close(out3, tda.decode_attend_q8kv_ref(*base, bound), rtol=0,
                               atol=_ATTN_ATOL)
    assert torch.all(out3[0] == 0)
    b = bound[:-1]
    sub = tuple(t[:7] for t in base)
    cur7 = tuple(t[:7] for t in cur)
    a = tda.decode_attend_q8kv_cur(*sub, b, *cur7)
    assert torch.equal(a, tda.decode_attend_q8kv(*_append_cur(sub, cur7, b), b + 1))


@pytest.mark.parametrize("form", [("dense", 0, 1), ("moe_top2", 4, 2)])
def test_tiny_decoder_serves_on_card_as_on_cpu(cuda, form):
    """A small W4 TinyDecoder (group 32; MoE: 4 int8 experts, top-2) on
    the card through ``chip_smoke.py`` phase 18's checks: ``ServeLoop``
    tokens equal each request's isolated ``generate`` bit for bit, and
    the card against the CPU under teacher forcing (logits within
    ``DECODER_CARD_CPU_TOL``) and prefill against incremental decode."""
    from micronet_tpu_torch.serve import Request, ServeLoop

    label, experts, top_k = form
    cs = _smoke()
    cs.DECODER_KW = dict(vocab=128, dim=64, heads=4, depth=2, mlp_dim=128, max_seq=32)
    cs.DECODER_TF_STEPS = 12
    _, model = cs._decoder_pair(experts, top_k, cuda, 0)
    loop = ServeLoop(model, 2, device=cuda)
    reqs = [Request(0, [12, 9, 7, 45], 6), Request(1, [3, 5], 9), Request(2, [1, 2, 3], 4)]
    for r in reqs:
        loop.submit(r)
    done = loop.run()
    for r in reqs:
        assert done[r.rid].output == model.generate(torch.tensor(r.prompt, device=cuda),
                                                    r.max_new_tokens).tolist()
    res = cs.decoder_card_vs_cpu(model, experts, top_k, label)
    assert res["card_vs_cpu_positions"] > len(cs.DECODER_PROMPT)


def test_registered_operators_equal_the_wrappers(cuda):
    """K1 and K2 called through their registered operators
    (``torch.ops.micronet_tpu_torch``) equal the public wrappers bit for
    bit, and each operator call counts one launch."""
    ops = torch.ops.micronet_tpu_torch
    for m, k, n in [(512, 512, 10), (1024, 1024, 1024)]:
        x, w_q, w_scale, s, z = _k1_inputs(m, k, n, 0.05, 1.0, seed=5)
        before = ti8.int8_matmul_dequant.launches
        got = ops.int8_matmul_dequant(x, w_q, w_scale, s, z, -128.0, 127.0)
        torch.cuda.synchronize()
        assert ti8.int8_matmul_dequant.launches == before + 1
        assert torch.equal(got, ti8.int8_matmul_dequant(x, w_q, w_scale, s, z))
        w3 = w_q.clamp(-1, 1)
        before = ti8.binary_act_matmul.launches
        got = ops.binary_act_matmul(x, w3, w_scale)
        torch.cuda.synchronize()
        assert ti8.binary_act_matmul.launches == before + 1
        assert torch.equal(got, ti8.binary_act_matmul(x, w3, w_scale))


def test_captured_k1_replays_equal_eager(cuda):
    """K1 captured in a CUDA graph (both regimes): the capture counts one
    launch, a replay counts none, and each replay on new inputs equals
    the eager call bit for bit."""
    for m, k, n in [(512, 512, 10), (1024, 1024, 1024)]:
        x, w_q, w_scale, s, z = _k1_inputs(m, k, n, 0.05, 0.0, seed=6)
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ti8.int8_matmul_dequant(static, w_q, w_scale, s, z)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ti8.int8_matmul_dequant.launches
        with torch.cuda.graph(graph):
            out = ti8.int8_matmul_dequant(static, w_q, w_scale, s, z)
        assert ti8.int8_matmul_dequant.launches == before + 1
        for seed in (7, 8):
            x2 = _k1_inputs(m, k, n, 0.05, 0.0, seed=seed)[0]
            static.copy_(x2)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, ti8.int8_matmul_dequant(x2, w_q, w_scale, s, z))
        assert ti8.int8_matmul_dequant.launches == before + 3


def test_compiled_engine_calls_do_not_alias(cuda):
    """Two calls of a ``CompiledEngine`` bucket in a row return separate
    tensors (a replay overwrites the bucket's static output): the first
    result keeps the eager engine's bits after the second call; padded and
    chunked requests equal the eager engine too."""
    from micronet_tpu_torch.infer import build_engine, freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models.resnet import BasicBlock, ResNet
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = _gen(12)
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)
    q = train_mode(prepare(ResNet(BasicBlock, [1, 1, 1, 1], device=cuda, generator=gen), cfg,
                           device=cuda))
    with torch.no_grad():
        for _ in range(3):
            q(torch.randn((16, 32, 32, 3), device=cuda, generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=cuda))
    x1, x2 = (torch.randn((8, 32, 32, 3), device=cuda, generator=gen) for _ in range(2))
    eng = eval_mode(freeze_int(fused, example_input=x1[:1], device=cuda))
    compiled = build_engine(eng, profile=(1, 4, 8), device=cuda)
    with torch.no_grad():
        ref1, ref2 = eng(x1), eng(x2)
    y1 = compiled(x1)
    y2 = compiled(x2)
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, ref1) and torch.equal(y2, ref2)
    x20 = torch.randn((20, 32, 32, 3), device=cuda, generator=gen)
    with torch.no_grad():
        for n in (3, 20):
            assert torch.equal(compiled(x20[:n]), eng(x20[:n]))


# ------------------------------------------------- the training lowerings


def _conv_calls(monkeypatch):
    """Every ``nn.functional.conv2d`` call's operand dtype, in order."""
    from micronet_tpu_torch.nn import functional as F

    calls, conv2d = [], F.conv2d

    def counted(x, w, *a, **k):
        calls.append(x.dtype)
        return conv2d(x, w, *a, **k)

    monkeypatch.setattr(F, "conv2d", counted)
    return calls


def test_auto_takes_both_lowerings_on_the_card(cuda, monkeypatch):
    """``"auto"`` on a CUDA tensor: one bf16 conv a ``QuantBNFuseConv2d``
    training forward (acc statistics, code operands, a bf16 output), two
    f32 ones on the exact path; a model built on the CPU and moved takes
    them too (resolved at call time)."""
    from micronet_tpu_torch.nn import qat_iao
    from micronet_tpu_torch.quant.config import QuantConfig

    x = torch.randn((8, 16, 8, 8), device=cuda, generator=_gen(20))
    for kw, want in [({}, [torch.bfloat16]), (dict(act_codes="off", bn_stats="off"),
                                              [torch.float32, torch.float32]),
                     (dict(q_type=1), [torch.bfloat16, torch.bfloat16, torch.bfloat16])]:
        layer = qat_iao.QuantBNFuseConv2d(16, 16, 3, padding=1, groups=2,
                                          cfg=QuantConfig(bn_fuse=True, **kw), device="cpu")
        layer.to(cuda)
        calls = _conv_calls(monkeypatch)
        out = layer(x)
        assert calls == want, kw
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        monkeypatch.undo()


def test_lowered_layers_track_the_exact_path_on_the_card(cuda):
    """Each lowered layer against the same layer on the exact path on the
    card, the JAX package's own bounds for its lowerings: the acc
    statistics' output within a median relative deviation of 0.02 and its
    running statistics within rtol 0.05 (atol 0.05); the code-storage
    convs and linears within bf16 rounding of their output (rtol 0.05)."""
    from micronet_tpu_torch.nn import qat_dorefa, qat_iao
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = _gen(21)
    exact = dict(act_codes="off", bn_stats="off")
    for calib in (False, True):
        auto = qat_iao.QuantBNFuseConv2d(32, 32, 3, padding=1, groups=4, bias=True,
                                         cfg=QuantConfig(bn_fuse=True, bn_fuse_calib=calib),
                                         device=cuda, generator=gen)
        ref = copy.deepcopy(auto)
        ref.cfg = QuantConfig(bn_fuse=True, bn_fuse_calib=calib, **exact)
        x = torch.randn((16, 32, 8, 8), device=cuda, generator=gen)
        with torch.no_grad():
            y, y_ref = auto(x), ref(x)
        rel = ((y - y_ref).abs() / (y_ref.abs() + 1e-2)).median()
        assert float(rel) < 0.02, float(rel)
        torch.testing.assert_close(auto.running_mean, ref.running_mean, rtol=0.05, atol=0.05)
        torch.testing.assert_close(auto.running_var, ref.running_var, rtol=0.05, atol=0.05)
    layers = [
        lambda c: qat_iao.QuantConv2d(32, 16, 3, padding=1, groups=2, cfg=c, device=cuda,
                                      generator=gen),
        lambda c: qat_iao.QuantConv2d(32, 16, 3, padding=1, cfg=dataclasses.replace(c, q_type=1),
                                      device=cuda, generator=gen),
        lambda c: qat_iao.QuantConvTranspose2d(32, 16, 4, stride=2, padding=1, cfg=c,
                                               device=cuda, generator=gen),
        lambda c: qat_dorefa.QuantConv2d(32, 16, 3, padding=1, cfg=c, device=cuda,
                                         generator=gen),
    ]
    x = torch.randn((8, 32, 8, 8), device=cuda, generator=gen) * 3
    for make in layers:
        auto = make(QuantConfig())
        ref = copy.deepcopy(auto)
        ref.cfg = dataclasses.replace(auto.cfg, **exact)
        with torch.no_grad():
            y, y_ref = auto(x), ref(x)
        torch.testing.assert_close(y, y_ref, rtol=0.05, atol=0.05 * y_ref.abs().max().item())
    lin = qat_iao.QuantLinear(64, 10, cfg=QuantConfig(), device=cuda, generator=gen)
    ref = copy.deepcopy(lin)
    ref.cfg = QuantConfig(**exact)
    xl = torch.randn((16, 64), device=cuda, generator=gen) * 3
    with torch.no_grad():
        torch.testing.assert_close(lin(xl), ref(xl), rtol=0.05,
                                   atol=0.05 * ref(xl).abs().max().item())


def test_remat_step_equals_plain_step_on_the_card(cuda):
    """A ``remat=True`` training step of a NIN-GC (narrow) with the
    lowerings equals a plain one in every parameter, gradient and buffer,
    bit for bit (cuDNN's deterministic algorithms in both)."""
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import TrainConfig, Trainer
    from micronet_tpu_torch.train import data as tdata

    ds = tdata.Cifar10(*tdata._synthetic(64, 16), source="synthetic")
    models, trainers = [], []
    for remat in (False, True):
        m = prepare(Net(cfg=[32] * 8, device="cpu", generator=torch.Generator().manual_seed(0)),
                    QuantConfig(bn_fuse=True), device="cpu")
        models.append(m)
        trainers.append(Trainer(train_mode(m), TrainConfig(batch_size=16, log_every=0,
                                                           remat=remat), dataset=ds,
                                device=cuda))
    x = torch.randn((16, 32, 32, 3), device=cuda, generator=_gen(22))
    y = torch.arange(16, device=cuda) % 10
    for _ in range(2):
        losses = [tr.train_step(x, y)[0] for tr in trainers]
        assert torch.equal(losses[0], losses[1])
        for (name, a), b in zip(models[1].named_parameters(), models[0].parameters()):
            assert torch.equal(a.grad, b.grad) and torch.equal(a, b), name
        for (name, a), b in zip(models[1].named_buffers(), models[0].buffers()):
            assert torch.equal(a, b), name


def test_graft_entry_on_the_card(cuda):
    """The entry's forward on the card (the lowerings) twice gives the same
    bits, and tracks the same weights on the CPU (the exact path) within
    bf16 rounding."""
    from micronet_tpu_torch.graft_entry import entry

    fn, (x,) = entry()
    cpu_fn, (cpu_x,) = entry("cpu")
    assert x.is_cuda and torch.equal(x.cpu(), cpu_x)
    with torch.no_grad():
        a, b = fn(x), fn(x)
        ref = cpu_fn(cpu_x)
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), ref, rtol=0.05,
                               atol=0.05 * max(1.0, ref.abs().max().item()))


def test_every_kernel_launches_on_its_tensors_card(cuda):
    """With card 0 current and every operand on card 1, each wrapper (K1 to
    K9) launches on card 1: its output lies there, equals the twin's, and
    equals the same call on card 0 bit for bit; card 0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    one = torch.device("cuda", 1)
    gen = _gen(7)
    w = torch.randn((512, 256), device=cuda, generator=gen) * 0.05
    w_q, scale = tim.quantize_int4_weight(w)
    wg_q, gs = tim.quantize_int4_weight_grouped(w, 64)
    x8, x200 = (torch.randn((m, 512), device=cuda, generator=gen) for m in (8, 200))
    xk = torch.randn((64, 96), device=cuda, generator=gen) * 2
    wk = torch.randint(-127, 128, (96, 40), dtype=torch.int8, device=cuda, generator=gen)
    wks = torch.rand((40,), device=cuda, generator=gen) * 0.02 + 1e-3
    s_x, zp = torch.tensor(0.05, device=cuda), torch.tensor(0.0, device=cuda)
    base, cur = _attn_case(4, 256, 128, 4, seed=8)
    long_base, long_cur = _attn_case(2, 1200, 128, 4, seed=9)
    bound = torch.tensor([0, 1, 100, 256], dtype=torch.int32, device=cuda)
    long_bound = torch.tensor([513, 1200], dtype=torch.int32, device=cuda)
    pool, table, lengths, q, pcur = _paged_case(3, 2, 4, 16, 8, seed=10)
    hl8 = tim.pack_int4_hl8(wg_q)
    calls = [
        ("K1", ti8.int8_matmul_dequant, ti8.int8_matmul_dequant_ref,
         (xk, wk, wks, s_x, zp, -128.0, 127.0), True),
        ("K2", ti8.binary_act_matmul, ti8.binary_act_matmul_ref, (xk, wk, wks), True),
        ("K3 regime A", tim.int4_matmul_grouped_hl8, tim.int4_matmul_grouped_hl8_ref,
         (x8, hl8, gs), False),
        ("K3 regime B", tim.int4_matmul_grouped_hl8, tim.int4_matmul_grouped_hl8_ref,
         (x200, hl8, gs), False),
        ("K8", tim.int4_matmul, tim.int4_matmul_ref, (x8, tim.pack_int4(w_q), scale), False),
        ("K9", tim.int4_matmul_grouped, tim.int4_matmul_grouped_ref,
         (x8, tim.pack_int4(wg_q), gs), False),
        ("K5a", tda.decode_attend_q8kv, tda.decode_attend_q8kv_ref, (*base, bound), False),
        ("K4a", tda.decode_attend_q8kv_cur, tda.decode_attend_q8kv_cur_ref,
         (*base, bound, *cur), False),
        ("K5b", tda.decode_attend_q8kv_blocked, tda.decode_attend_q8kv_ref,
         (*long_base, long_bound), False),
        ("K4b", tda.decode_attend_q8kv_blocked_cur, tda.decode_attend_q8kv_cur_ref,
         (*long_base, long_bound, *long_cur), False),
        ("K7", tpa.paged_decode_attend, tpa.paged_decode_attend_ref,
         (*pool, table, lengths, q), False),
        ("K6", tpa.paged_decode_attend_cur, tpa.paged_decode_attend_cur_ref,
         (*pool, table, lengths, q, *pcur), False),
    ]
    for name, fn, twin, args, exact in calls:
        on_one = [a.to(one) if isinstance(a, torch.Tensor) else a for a in args]
        before = fn.launches
        out = fn(*on_one)
        torch.cuda.synchronize(one)
        assert fn.launches == before + 1, name
        assert out.device == one and torch.cuda.current_device() == 0, name
        ref = twin(*args)
        if exact:
            assert torch.equal(out.cpu(), ref.cpu()), name
        else:
            torch.testing.assert_close(out.cpu(), ref.cpu(), rtol=0,
                                       atol=max(_ATTN_ATOL, 2e-5 * ref.abs().max().item()),
                                       msg=name)
        assert torch.equal(out.cpu(), fn(*args).cpu()), name
