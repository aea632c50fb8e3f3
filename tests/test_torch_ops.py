"""The port's kernels (ops/) and quantizers against the JAX package.

The same numpy inputs go through the JAX function and the port. On the
CPU the port's wrappers run their plain PyTorch twins; JAX runs the hl8
matmul's real Pallas kernel in interpret mode and the decode attention
through its XLA oracle, as the JAX package's own tests do. The kernels
themselves are held against these twins on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micronet_tpu.ops import decode_attention as jda
from micronet_tpu.ops import int4_matmul as jim
from micronet_tpu.quant import kv_cache as jkv
from micronet_tpu_torch.ops import decode_attention as tda
from micronet_tpu_torch.ops import int4_matmul as tim
from micronet_tpu_torch.quant import kv_cache as tkv


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _half_codes(shape, qmax, seed):
    """Values k + 0.5 in (-qmax, qmax): with a scale of exactly 1 they sit
    on the boundaries where half-away and half-even rounding differ."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-qmax, qmax, size=shape).astype(np.float32) + 0.5
    x[::2] *= -1
    return x


# --------------------------------------------------------------------------
# quantizers and packing: bit-exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("qmax,group", [(7.0, 16), (127.0, 32)])
def test_symmetric_rtn_grouped_bit_exact(qmax, group):
    half = _half_codes((64, 24), int(qmax), 1)
    half[::group] = qmax  # absmax qmax in every group: scale exactly 1
    w = np.concatenate([_np(0, (64, 24), 0.05), half])
    qj, sj = jim.symmetric_rtn_grouped(jnp.asarray(w), qmax, group)
    qt, st = tim.symmetric_rtn_grouped(torch.from_numpy(w), qmax, group)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.all(st.numpy()[64 // group:] == 1.0)  # the .5 cases are real


def test_quantize_kv_rows_bit_exact():
    half = _half_codes((24, 16), 127, 3)
    half[:, 0] = 127.0  # absmax 127 in every row: scale exactly 1
    x = np.concatenate([_np(2, (40, 16), 3.0), half])
    x = x.reshape(4, 16, 16)
    qj, sj = jkv.quantize_kv_rows(jnp.asarray(x))
    qt, st = tkv.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # torch.round (half to even) would disagree on these rows
    half_even = np.clip(np.round(x / st.numpy()), -127, 127)
    assert np.any(half_even != qt.numpy())


def test_hl8_pack_bit_exact_and_roundtrip():
    codes = np.arange(-8, 8, dtype=np.int8)
    # every (low, high) nibble pair, plus random codes
    w_q = np.concatenate([np.tile(codes[:, None], (1, 16)), np.tile(codes[None, :], (16, 1))])
    w_q = np.concatenate([w_q, np.random.default_rng(4).integers(-8, 8, (32, 16))], axis=1)
    w_q = w_q.astype(np.int8)
    pj = np.asarray(jim.pack_int4_hl8(jnp.asarray(w_q)))
    pt = tim.pack_int4_hl8(torch.from_numpy(w_q))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tim.unpack_int4_hl8(pt).numpy(), w_q)
    np.testing.assert_array_equal(tim.pack_int4(torch.from_numpy(w_q)).numpy(),
                                  np.asarray(jim.pack_int4(jnp.asarray(w_q))))
    # the hl8 byte identity b = 16 * q_hi + (q_lo + 8)
    b = pt.numpy().astype(np.int32)
    np.testing.assert_array_equal(b, 16 * w_q[16:].astype(np.int32) + w_q[:16] + 8)


# --------------------------------------------------------------------------
# K3: int4_matmul_grouped_hl8
# --------------------------------------------------------------------------


def _hl8_case(m, k, n, g, seed=0):
    w = _np(seed + 1, (k, n), 0.05)
    x = _np(seed, (m, k))
    w_q, gs = jim.quantize_int4_weight_grouped(jnp.asarray(w), g)
    return x, np.asarray(jim.pack_int4_hl8(w_q)), np.asarray(gs)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("k,n,g", [(256, 128, 64), (512, 96, 32)])
def test_int4_hl8_twin_matches_jax(m, k, n, g):
    x, ph, gs = _hl8_case(m, k, n, g)
    kern = np.asarray(jim.int4_matmul_grouped_hl8(x, ph, gs))  # Pallas, interpret mode
    orc = np.asarray(jim.int4_matmul_grouped_hl8_xla(x, ph, gs))
    before = tim.int4_matmul_grouped_hl8.launches
    out = tim.int4_matmul_grouped_hl8(
        torch.from_numpy(x), torch.from_numpy(ph), torch.from_numpy(gs)
    ).numpy()
    assert tim.int4_matmul_grouped_hl8.launches == before  # CPU: the twin ran
    # every product bf16(x) * code is exact in f32; the paths differ only
    # in f32 summation order (the JAX three-dot identity reorders terms)
    mag = np.abs(orc).max()
    np.testing.assert_allclose(out, orc, rtol=0, atol=1e-5 * mag)
    np.testing.assert_allclose(out, kern, rtol=0, atol=1e-5 * mag)


def test_wo_linear_grouped_hl8_leading_dims():
    x, ph, gs = _hl8_case(6, 128, 64, 32, seed=5)
    out = tim.wo_linear_grouped_hl8(
        torch.from_numpy(x.reshape(2, 3, 128)), torch.from_numpy(ph), torch.from_numpy(gs))
    ref = jim.wo_linear_grouped_hl8(jnp.asarray(x.reshape(2, 3, 128)), ph, gs)
    assert out.shape == (2, 3, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def test_int4_hl8_rejects_group_not_dividing_half_k():
    x, ph, gs = _hl8_case(1, 96, 32, 32)  # K/2 = 48 is not a multiple of 32
    with pytest.raises(ValueError, match="must divide K/2"):
        tim.int4_matmul_grouped_hl8(
            torch.from_numpy(x), torch.from_numpy(ph), torch.from_numpy(gs))


# --------------------------------------------------------------------------
# K4a / K5a: decode attention over the int8 cache
# --------------------------------------------------------------------------


def _attn_case(g, s, d, r, seed):
    rng = np.random.default_rng(seed)
    kc = rng.integers(-127, 128, (g, s, d)).astype(np.int8)
    vc = rng.integers(-127, 128, (g, s, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (g, s)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (g, s)).astype(np.float32)
    q = _np(seed + 1, (g, r, d) if r else (g, d))
    cur = (rng.integers(-127, 128, (g, d)).astype(np.int8),
           rng.uniform(0.001, 0.02, (g,)).astype(np.float32),
           rng.integers(-127, 128, (g, d)).astype(np.int8),
           rng.uniform(0.001, 0.02, (g,)).astype(np.float32))
    return kc, ks, vc, vs, q, cur


# ragged fills, including an empty and a full cache
_BOUNDS = np.array([0, 1, 7, 32, 19, 2], np.int32)
# Both sides compute in f32 on the CPU with the same bf16 rounding points;
# they differ in the order of f32 sums and in exp's last bit (measured:
# 6e-8 on outputs of size ~1).
_ATTN_ATOL = 1e-5


@pytest.mark.parametrize("r", [0, 1, 2, 4])  # 0: the (G, D) query form
def test_decode_attend_q8kv_twin_matches_jax(r):
    kc, ks, vc, vs, q, _ = _attn_case(6, 32, 16, r, seed=10 + r)
    ref = np.asarray(jda.decode_attend_q8kv_xla(kc, ks, vc, vs, q, _BOUNDS))
    out = tda.decode_attend_q8kv(*map(torch.from_numpy, (kc, ks, vc, vs, q, _BOUNDS))).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=_ATTN_ATOL)
    assert np.all(out[0] == 0)  # bound 0: nothing visible


@pytest.mark.parametrize("r", [0, 1, 2, 4])
def test_decode_attend_q8kv_cur_twin_matches_jax(r):
    kc, ks, vc, vs, q, cur = _attn_case(6, 32, 16, r, seed=20 + r)
    ref = np.asarray(jda.decode_attend_q8kv_cur_xla(kc, ks, vc, vs, q, _BOUNDS, *cur))
    out = tda.decode_attend_q8kv_cur(
        *map(torch.from_numpy, (kc, ks, vc, vs, q, _BOUNDS) + cur)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=_ATTN_ATOL)


def test_cur_column_equals_append_then_attend():
    """K4a at bound b == K5a at bound b + 1 over a cache whose row b holds
    the current row: the deferred append changes nothing but the order
    of f32 sums."""
    kc, ks, vc, vs, q, cur = _attn_case(6, 33, 16, 2, seed=30)
    bound = np.array([0, 1, 7, 32, 19, 2], np.int32)
    kc2, ks2, vc2, vs2 = kc.copy(), ks.copy(), vc.copy(), vs.copy()
    for i, b in enumerate(bound):
        kc2[i, b], ks2[i, b], vc2[i, b], vs2[i, b] = cur[0][i], cur[1][i], cur[2][i], cur[3][i]
    t = torch.from_numpy
    a = tda.decode_attend_q8kv_cur(t(kc), t(ks), t(vc), t(vs), t(q), t(bound), *map(t, cur))
    b = tda.decode_attend_q8kv(t(kc2), t(ks2), t(vc2), t(vs2), t(q), t(bound + 1))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_attend_decode_and_prefill_match_jax():
    """``attend`` at T = 1 (the K5a path, GQA r = 2) and at T > 1 (plain
    f32 prefill) against the JAX package over the same appended cache."""
    h, s, d = 2, 16, 8
    k, v = _np(40, (h, 5, d)), _np(41, (h, 5, d))
    cj = jkv.append_kv(jkv.init_kv_cache(h, s, d), jnp.asarray(k), jnp.asarray(v))
    ct = tkv.append_kv(tkv.init_kv_cache(h, s, d, device="cpu"),
                       torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(ct.k_codes.numpy(), np.asarray(cj.k_codes))
    np.testing.assert_array_equal(ct.v_scale.numpy(), np.asarray(cj.v_scale))
    assert int(ct.length) == int(cj.length) == 5
    for t_len, off in ((1, 4), (5, 0)):
        q = _np(42 + t_len, (2 * h, t_len, d))
        ref = np.asarray(jkv.attend(cj, jnp.asarray(q), causal_offset=jnp.int32(off)))
        out = tkv.attend(ct, torch.from_numpy(q), causal_offset=off).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=_ATTN_ATOL)


def test_append_batch_clamps_and_saturates():
    b, h, s, d = 3, 2, 4, 8
    c = tkv.init_kv_cache(h, s, d, batch=b, device="cpu")
    c.length = torch.tensor([0, 3, 4], dtype=torch.int32)
    kq = torch.full((b, h, d), 5, dtype=torch.int8)
    ks = torch.ones((b, h))
    tkv.append_kv_batch_quantized(c, kq, ks, kq, ks)
    assert c.length.tolist() == [1, 4, 4]
    assert c.k_codes[0, :, 0].eq(5).all() and c.k_codes[1, :, 3].eq(5).all()
    assert c.k_codes[2, :, 3].eq(5).all()  # a full slot writes its last row


@pytest.mark.parametrize("group,bits", [(16, 4), (0, 4), (32, 8), (0, 8)])
def test_wo_linear_matches_jax(group, bits):
    """Every WOLinear path against the JAX package on the same weights:
    grouped and per-column int4 on the hl8 kernel's twin (K = 256 packs
    to 128 rows), and int8 as bf16 operands with f32 sums."""
    from flax import nnx

    from micronet_tpu.nn.modules import Linear as JLinear
    from micronet_tpu.quant.weight_only import wo_quantize_linear as jwo
    from micronet_tpu_torch.nn.modules import Linear as TLinear
    from micronet_tpu_torch.quant.weight_only import wo_quantize_linear as two

    jlin = JLinear(256, 48, bias=True, rngs=nnx.Rngs(3))
    tlin = TLinear(256, 48, bias=True, device="cpu")
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(np.asarray(jlin.weight[...])))
        tlin.bias.copy_(torch.from_numpy(np.asarray(jlin.bias[...])))
    jq, tq = jwo(jlin, group, bits), two(tlin, group, bits)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed[...]))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale[...]))
    x = _np(60, (3, 256))
    ref = np.asarray(jq(jnp.asarray(x)))
    out = tq(torch.from_numpy(x)).numpy()
    # exact products on both sides; f32 summation order differs
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # the float layer itself
    np.testing.assert_allclose(tlin(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jlin(jnp.asarray(x))), rtol=0, atol=1e-5)


def test_kv_cache_bytes_matches_jax():
    cj = jkv.init_kv_cache(2, 16, 8)
    ct = tkv.init_kv_cache(2, 16, 8, device="cpu")
    assert tkv.kv_cache_bytes(ct) == jkv.kv_cache_bytes(cj)


# --------------------------------------------------------------------------
# K1: int8_matmul_dequant
# --------------------------------------------------------------------------


def _k1_case(m, k, n, scale, zp, seed):
    """x with a share of its values placed on .5 code boundaries
    (x / s = j + 0.5 exactly), int8 weights, per-column scales."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 40 * scale).astype(np.float32)
    ties = (rng.integers(-20, 20, (m, k)) + 0.5).astype(np.float32) * np.float32(scale)
    x = np.where(rng.random((m, k)) < 0.25, ties, x).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 2e-2, (n,)).astype(np.float32)
    return x, w_q, w_scale, np.float32(scale), np.float32(zp)


# A8 and A4 ranges; ragged M, K, N (none a multiple of a tile); zp != 0
_K1_CASES = [
    (5, 37, 10, 0.25, 0.0, -128.0, 127.0),
    (33, 200, 19, 0.0625, 3.0, -128.0, 127.0),
    (17, 64, 130, 0.5, 0.0, -8.0, 7.0),
    (9, 130, 7, 0.125, -2.0, -8.0, 7.0),
]


@pytest.mark.parametrize("m,k,n,scale,zp,qmin,qmax", _K1_CASES)
def test_int8_matmul_dequant_twin_bit_exact_vs_jax(m, k, n, scale, zp, qmin, qmax):
    """The K1 twin equals the JAX Pallas kernel (interpret mode) and the
    XLA oracle bit for bit: exact int32 products, the same f32 quantize
    and epilogue operations."""
    from micronet_tpu.ops import int_matmul as jim8
    from micronet_tpu_torch.ops import int_matmul as tim8

    x, w_q, w_scale, s, z = _k1_case(m, k, n, scale, zp, seed=m * 1000 + k)
    kern = np.asarray(jim8.int8_matmul_dequant(x, w_q, w_scale, s, z, qmin=qmin, qmax=qmax))
    orc = np.asarray(jim8.int8_matmul_dequant_xla(x, w_q, w_scale, s, z, qmin=qmin, qmax=qmax))
    before = tim8.int8_matmul_dequant.launches
    out = tim8.int8_matmul_dequant(torch.from_numpy(x), torch.from_numpy(w_q),
                                   torch.from_numpy(w_scale), float(s), float(z),
                                   qmin, qmax).numpy()
    assert tim8.int8_matmul_dequant.launches == before  # CPU: the twin ran
    np.testing.assert_array_equal(out, orc)
    np.testing.assert_array_equal(out, kern)
    # the activation codes clip at the activation range, not int8's
    codes = tim8.quantize_int8(torch.from_numpy(x), float(s), float(z), qmin, qmax)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jim8.quantize_int8(x, s, z, qmin, qmax)))
    assert codes.min().item() >= qmin and codes.max().item() <= qmax


def test_int8_linear_matches_jax_with_bias_and_leading_dims():
    from micronet_tpu.ops import int_matmul as jim8
    from micronet_tpu_torch.ops import int_matmul as tim8

    x, w_q, w_scale, s, z = _k1_case(6, 48, 12, 0.125, 0.0, seed=7)
    bias = _np(8, (12,))
    x3 = x.reshape(2, 3, 48)
    ref = np.asarray(jim8.int8_linear(jnp.asarray(x3), w_q, w_scale, s, z, jnp.asarray(bias)))
    out = tim8.int8_linear(torch.from_numpy(x3), torch.from_numpy(w_q),
                           torch.from_numpy(w_scale), torch.tensor(s), torch.tensor(z),
                           torch.from_numpy(bias)).numpy()
    assert out.shape == (2, 3, 12)
    np.testing.assert_array_equal(out, ref)


def test_int8_linear_on_a_card_tensor_launches_or_raises(monkeypatch):
    """A tensor on the card takes the kernel path, never the twin: without
    a built kernel the call raises instead of falling back."""
    from micronet_tpu_torch.ops import _build
    from micronet_tpu_torch.ops import int_matmul as tim8

    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    _build._cdll.cache_clear()
    x, w_q, w_scale, s, z = _k1_case(4, 16, 8, 0.125, 0.0, seed=9)
    before = tim8.int8_matmul_dequant.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tim8.int8_linear(torch.from_numpy(x), torch.from_numpy(w_q),
                         torch.from_numpy(w_scale), float(s), float(z))
    assert tim8.int8_matmul_dequant.launches == before  # nothing launched
