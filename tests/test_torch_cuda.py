"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Every test here needs a CUDA card and skips without one. The file
imports torch and numpy only (no JAX), so it also runs on a machine that
has no JAX, without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py
"""

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
