"""K2 (``binary_act_matmul``), K8 (``int4_matmul``), K9
(``int4_matmul_grouped``), their dispatchers and the weight-only pytree
API of the port against the JAX package.

The same numpy inputs go through the JAX function and the port. On the
CPU the port's wrappers run their plain PyTorch twins; JAX runs the
Pallas kernels in interpret mode and the XLA oracles, as its own tests
do. The kernels themselves are held against these twins on the card by
``tests/test_torch_cuda.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micronet_tpu.ops import int4_matmul as jim
from micronet_tpu.ops import int_matmul as jim8
from micronet_tpu.quant import weight_only as jwo
from micronet_tpu_torch.ops import int4_matmul as tim
from micronet_tpu_torch.ops import int_matmul as tim8
from micronet_tpu_torch.quant import weight_only as two


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# K2: binary_act_matmul
# --------------------------------------------------------------------------


def _k2_case(m, k, n, seed):
    """x with exact zeros, -0.0 and values of both signs; ternary w_q;
    alphas in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[rng.random((m, k)) < 0.1] = 0.0
    x[rng.random((m, k)) < 0.1] = -0.0
    w_q = rng.integers(-1, 2, (k, n)).astype(np.int8)
    alpha = (0.5 + rng.random(n)).astype(np.float32)
    return x, w_q, alpha


@pytest.mark.parametrize("m,k,n", [(40, 128, 96), (33, 256, 130), (7, 100, 5), (333, 200, 19)])
def test_binary_act_matmul_twin_bit_exact_vs_jax(m, k, n):
    """K % 128 == 0 runs the JAX Pallas kernel (interpret mode), otherwise
    its XLA route; the twin equals both bit for bit, and the numpy
    reference: +1 for 0 and -0.0."""
    x, w_q, alpha = _k2_case(m, k, n, seed=m + k + n)
    ref = np.asarray(jim8.binary_act_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                            jnp.asarray(alpha)))
    before = tim8.binary_act_matmul.launches
    out = tim8.binary_act_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                                 torch.from_numpy(alpha)).numpy()
    assert tim8.binary_act_matmul.launches == before  # CPU: the twin ran
    np.testing.assert_array_equal(out, ref)
    signs = np.where(x >= 0, 1, -1).astype(np.int64)
    np.testing.assert_array_equal(
        out, (signs @ w_q.astype(np.int64)).astype(np.float32) * alpha[None, :])
    assert np.signbit(x).any() and (x == 0).any()


def test_binary_act_matmul_nan_is_minus_one_and_scalar_alpha():
    x = np.array([[np.nan, 0.0, -0.0, -1.0]], np.float32)
    w_q = np.eye(4, dtype=np.int8)
    out = tim8.binary_act_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                                 torch.tensor(2.0)).numpy()
    np.testing.assert_array_equal(out, [[-2.0, 2.0, 2.0, -2.0]])
    ref = np.asarray(jim8.binary_act_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                            jnp.float32(2.0)))
    np.testing.assert_array_equal(out, ref)


# --------------------------------------------------------------------------
# K8 and K9: plain-packed int4
# --------------------------------------------------------------------------


def _k8_case(m, k, n, seed):
    w = _np(seed + 1, (k, n), 0.1)
    w_q, scale = jim.quantize_int4_weight(jnp.asarray(w), axis=0)
    return _np(seed, (m, k)), np.asarray(jim.pack_int4(w_q)), np.asarray(scale)


def _k9_case(m, k, n, g, seed, outlier=False):
    w = _np(seed + 1, (k, n), 0.05)
    if outlier:
        w[3] *= 30.0
    w_q, gscale = jim.quantize_int4_weight_grouped(jnp.asarray(w), g)
    return _np(seed, (m, k)), np.asarray(jim.pack_int4(w_q)), np.asarray(gscale)


@pytest.mark.parametrize("m,k,n", [(24, 192, 130), (1, 256, 64), (8, 512, 96)])
def test_int4_matmul_twin_matches_jax(m, k, n):
    """Every product bf16(x) * code is exact in f32; the paths differ only
    in f32 summation order (K3's precision class)."""
    x, packed, scale = _k8_case(m, k, n, seed=m + k)
    kern = np.asarray(jim.int4_matmul(x, packed, scale))  # Pallas, interpret mode
    orc = np.asarray(jim.int4_matmul_xla(jnp.asarray(x), packed, scale))
    before = tim.int4_matmul.launches
    out = tim.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                          torch.from_numpy(scale)).numpy()
    assert tim.int4_matmul.launches == before
    mag = np.abs(orc).max()
    np.testing.assert_allclose(out, orc, rtol=0, atol=1e-5 * mag)
    np.testing.assert_allclose(out, kern, rtol=0, atol=1e-5 * mag)


@pytest.mark.parametrize("m,k,n,g,outlier", [(24, 512, 256, 128, False),
                                             (24, 512, 256, 128, True),
                                             (3, 256, 96, 32, False),
                                             (1, 384, 64, 64, True)])
def test_int4_matmul_grouped_twin_matches_jax(m, k, n, g, outlier):
    """The weights dequantize to bf16 before the dot on both sides (the
    same rounded values); f32 sums in another order."""
    x, packed, gs = _k9_case(m, k, n, g, seed=k + g, outlier=outlier)
    kern = np.asarray(jim.int4_matmul_grouped(x, packed, gs, bm=16, bn=128))
    orc = np.asarray(jim.int4_matmul_grouped_xla(jnp.asarray(x), packed, gs))
    before = tim.int4_matmul_grouped.launches
    out = tim.int4_matmul_grouped(torch.from_numpy(x), torch.from_numpy(packed),
                                  torch.from_numpy(gs)).numpy()
    assert tim.int4_matmul_grouped.launches == before
    mag = np.abs(orc).max()
    np.testing.assert_allclose(out, orc, rtol=0, atol=1e-5 * mag)
    np.testing.assert_allclose(out, kern, rtol=0, atol=1e-5 * mag)
    # the dequantized weights themselves are the oracle's, bit for bit
    wj = np.asarray(jim._dequant_grouped_bf16(jnp.asarray(packed), jnp.asarray(gs), g)
                    .astype(jnp.float32))
    wt = tim._dequant_grouped_bf16(torch.from_numpy(packed), torch.from_numpy(gs), g)
    np.testing.assert_array_equal(wt.numpy(), wj)


def test_wo_linear_and_wo_linear_grouped_over_leading_dims():
    x, packed, scale = _k8_case(6, 128, 64, seed=5)
    x3 = x.reshape(2, 3, 128)
    out = tim.wo_linear(torch.from_numpy(x3), torch.from_numpy(packed), torch.from_numpy(scale))
    ref = np.asarray(jim.wo_linear(jnp.asarray(x3), packed, scale))
    assert out.shape == (2, 3, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    x, packed, gs = _k9_case(6, 256, 64, 32, seed=6)
    x3 = x.reshape(3, 2, 256)
    out = tim.wo_linear_grouped(torch.from_numpy(x3), torch.from_numpy(packed),
                                torch.from_numpy(gs))
    ref = np.asarray(jim.wo_linear_grouped(jnp.asarray(x3), packed, gs))
    assert out.shape == (3, 2, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_int4_matmul_grouped_rejects_group_not_dividing_half_k():
    x, packed, gs = _k9_case(1, 96, 32, 32, seed=7)  # K/2 = 48 is not a multiple of 32
    with pytest.raises(ValueError, match="must divide K/2"):
        tim.wo_linear_grouped(torch.from_numpy(x), torch.from_numpy(packed),
                              torch.from_numpy(gs))
    with pytest.raises(AssertionError):  # the JAX kernel refuses it too
        jim.int4_matmul_grouped(x, packed, gs)


@pytest.mark.parametrize("name", ["binary_act_matmul", "int4_matmul", "int4_matmul_grouped"])
def test_wrappers_on_a_card_tensor_launch_or_raise(monkeypatch, name):
    """A tensor on the card takes the kernel path, never the twin: without
    a built kernel the call raises instead of falling back."""
    from micronet_tpu_torch.ops import _build

    mod = tim8 if name == "binary_act_matmul" else tim
    monkeypatch.setattr(mod, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    _build._cdll.cache_clear()
    if name == "binary_act_matmul":
        args = _k2_case(4, 16, 8, seed=9)
    elif name == "int4_matmul":
        args = _k8_case(4, 16, 8, seed=9)
    else:
        args = _k9_case(4, 32, 8, 8, seed=9)
    fn = getattr(mod, name)
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    assert fn.launches == before  # nothing launched


def test_build_load_binds_a_library_once(monkeypatch):
    """``_build.load`` sets each entry point's argtypes on the first load of
    a library only; later loads (one per wrapper call) leave them alone."""
    import ctypes

    from micronet_tpu_torch.ops import _build

    class Entry:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            self.mn_f = Entry()

    libs = {(): Lib(), ("W4_NO_REDUCE",): Lib()}
    monkeypatch.setattr(_build, "_cdll", lambda name, defines=(): libs[defines])
    sig = {"mn_f": [ctypes.c_void_p, ctypes.c_int]}
    assert _build.load("int4_matmul", sig) is libs[()]
    assert libs[()].mn_f.argtypes == sig["mn_f"] and libs[()].mn_f.restype is ctypes.c_int
    libs[()].mn_f.argtypes = None
    assert _build.load("int4_matmul", sig) is libs[()]
    assert libs[()].mn_f.argtypes is None  # not bound again
    assert _build.load("int4_matmul", sig, ("W4_NO_REDUCE",)) is libs[("W4_NO_REDUCE",)]
    assert libs[("W4_NO_REDUCE",)].mn_f.argtypes == sig["mn_f"]


def test_build_names_a_macro_build_apart():
    """A diagnostic build (macros defined) gets a library name of its own, so
    it never loads in place of the kernel; the plain build's name does not
    depend on the defines argument's default."""
    from micronet_tpu_torch.ops import _build

    plain = _build._lib_path("int4_matmul")
    assert _build._lib_path("int4_matmul", ()) == plain
    names = {plain, _build._lib_path("int4_matmul", ("W4_NO_COMPUTE",)),
             _build._lib_path("int4_matmul", ("W4_NO_REDUCE",))}
    assert len(names) == 3 and all(p.parent == _build.BUILD_DIR for p in names)


# --------------------------------------------------------------------------
# K8/K9's card kernel: its dequantize bit tricks and its K-split, mirrored in numpy
# --------------------------------------------------------------------------


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of (b << 32 | a)."""
    both = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros_like(a, dtype=np.uint32)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def _bf16_bits_to_f32(bits16):
    return (bits16.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _round_bf16_rne(f):
    """f32 -> the nearest bf16 (ties to even), held in f32: cvt.rn.bf16x2.f32 on
    finite values."""
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) >> np.uint64(16)
    return _bf16_bits_to_f32(u.astype(np.uint32))


def _all_byte_pairs():
    """(2, 65536) int8 packed rows: every (row 0 byte, row 1 byte) pair once, in
    every column position of a 4-byte word."""
    p0 = np.tile(np.arange(256, dtype=np.uint32), 256)
    p1 = np.repeat(np.arange(256, dtype=np.uint32), 256)
    p1 = np.roll(p1, 1)  # mixes the word position of each pair
    return np.stack([p0, p1]).astype(np.uint8).view(np.int8)


def _words(row):
    return np.ascontiguousarray(row).view(np.uint32)  # little-endian: column 4q + i is byte i


def test_k8_dequant_bits_equal_unpack_int4_on_every_byte():
    """The kernel's K8 dequantize, bit for bit: a byte permute puts columns
    (2j, 2j + 1) of packed rows 0 and 1 side by side; for v = t, t >> 8,
    t >> 4, t >> 12, (v & 0x000F000F) ^ 0x43084308 is two bf16 128 + (q + 8)
    and minus 136 gives q: the same codes as unpack_int4, both nibbles."""
    packed = _all_byte_pairs()
    codes = tim.unpack_int4(torch.from_numpy(packed)).numpy().astype(np.float32)
    lo_ref, hi_ref = codes[:2], codes[2:]  # rows (0, 1) of each half
    w0, w1 = _words(packed[0]), _words(packed[1])
    for j in range(2):  # the word's columns (0, 1) and (2, 3)
        t = _byte_perm(w0, w1, 0x7632 if j else 0x5410)
        for shift, half, e in ((0, lo_ref, 0), (8, lo_ref, 1), (4, hi_ref, 0), (12, hi_ref, 1)):
            v = ((t >> np.uint32(shift)) & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
            for r, bits in enumerate((v & np.uint32(0xFFFF), v >> np.uint32(16))):
                q = _bf16_bits_to_f32(bits) - np.float32(136.0)  # exact in bf16 and in f32
                np.testing.assert_array_equal(q, half[r, 2 * j + e::4])


@pytest.mark.parametrize("lo,hi", [(-8, 2), (-40, 40), (-120, 120)])
def test_k9_dequant_bits_equal_twin_on_every_byte(lo, hi):
    """The kernel's K9 dequantize, bit for bit: (nibble ^ 8) permuted into
    the mantissa of f32 2^23, minus 2^23 + 8, is q; one f32 multiply by the
    group scale and one rounding to bf16 give the twin's
    bf16(f32(q) * gscale) for scales of both signs across 2^lo .. 2^hi."""
    packed = _all_byte_pairs()
    rng = np.random.default_rng(hi)
    n = packed.shape[1]
    gscale = (2.0 ** rng.uniform(lo, hi, (2, n)) * rng.choice([-1, 1], (2, n))).astype(np.float32)
    ref = tim._dequant_grouped_bf16(torch.from_numpy(packed), torch.from_numpy(gscale), 2).numpy()
    for r in range(2):
        w = _words(packed[r])
        for half, v in ((0, (w & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)),
                        (1, ((w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808))):
            for byte in range(4):
                f = _byte_perm(v, np.full_like(v, 0x4B000000), 0x7650 | byte).view(np.float32)
                q = f - np.float32(8388616.0)  # 2^23 + 8: exact
                s = gscale[half, byte::4]
                np.testing.assert_array_equal(_round_bf16_rne(q * s), ref[2 * half + r, byte::4])


_8B_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256)]
_CARD_TEST_SHAPES = [(640, 100), (200, 4), (1000, 4000), (2560, 256), (512, 64), (14336, 512)]
# K3's regime A takes the same split rule (its groups, 32 to 256 and 50, divide K/2 and may be cut
# by a split boundary): the shapes of its card test that K8/K9's do not have
_K3_CARD_TEST_SHAPES = [(1024, 768), (512, 100), (672, 136), (1024, 512), (1000, 400)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("k,n", _8B_SHAPES + _CARD_TEST_SHAPES + _K3_CARD_TEST_SHAPES)
def test_w4_splits_take_no_m_and_cover_every_packed_row_once(k, n, sms):
    """The w4 kernel's (K8, K9, K3's regime A) K-split is a function of K/2, N and the SM count only, so a
    row's result cannot depend on its batch; cut as the kernel cuts it
    (units of 64 packed rows, split s taking units [U s / S, U (s + 1) / S)),
    every split is non-empty and every packed row falls in exactly one; a
    split call of up to ``_W4_KEEP_ROWS`` batch rows fits the workspace the
    wrapper keeps (2 x SMs x 128 x 16 floats)."""
    assert list(inspect.signature(tim._w4_splits).parameters) == ["k2", "n", "sms"]
    k2 = k // 2
    splits = tim._w4_splits(k2, n, sms)
    units = -(-k2 // tim._W4_UNIT)
    assert 1 <= splits <= units
    covered = np.zeros(k2, np.int64)
    for s in range(splits):
        r0 = units * s // splits * tim._W4_UNIT
        r1 = min(units * (s + 1) // splits * tim._W4_UNIT, k2)
        assert r0 < r1
        covered[r0:r1] += 1
    np.testing.assert_array_equal(covered, 1)
    if splits > 1:
        assert (splits * tim._W4_KEEP_ROWS * n
                <= 2 * sms * tim._W4_BLOCK_N * tim._W4_KEEP_ROWS)
    if sms == 132 and n == 4096:  # enough blocks for the card at N = 4096
        assert splits * -(-n // tim._W4_BLOCK_N) >= sms


# --------------------------------------------------------------------------
# quantize_pytree / dequantize_leaf / pytree_bytes
# --------------------------------------------------------------------------


def _params():
    rng = np.random.default_rng(11)
    f = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {
        "blocks": [{"w1": f(256, 384), "w2": f(384, 256), "ln": np.ones(256, np.float32)},
                   {"w1": f(256, 384), "w2": f(384, 256), "ln": np.ones(256, np.float32)}],
        "emb": f(512, 256),
        "head": (f(256, 100), f(100)),
        "small": f(8, 8),
        "odd_k": f(129, 64),
    }


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("bits,group", [(4, 0), (4, 128), (8, 0), (8, 64)])
def test_quantize_pytree_matches_jax(bits, group):
    """The same leaves quantize (2-D, floating, at least ``min_size``, not
    vetoed by the predicate), to the same codes and scales; the same
    dequantized values and byte counts. The predicate sees plain keys in
    the port, ``jax.tree_util`` key entries in JAX."""
    params = _params()
    jparams = _to(params, jnp.asarray)
    tparams = _to(params, torch.from_numpy)
    jq = jwo.quantize_pytree(jparams, min_size=1000, group=group, bits=bits,
                             predicate=lambda p, l: "emb" not in jax.tree_util.keystr(p))
    tq = two.quantize_pytree(tparams, min_size=1000, group=group, bits=bits,
                             predicate=lambda p, l: "emb" not in p)
    is_wo = lambda l: isinstance(l, jwo.WOTensor)
    jleaves = jax.tree_util.tree_leaves_with_path(jq, is_leaf=is_wo)
    quantized = {jax.tree_util.keystr(p) for p, l in jleaves if is_wo(l)}
    assert quantized == {"['blocks'][0]['w1']", "['blocks'][0]['w2']", "['blocks'][1]['w1']",
                         "['blocks'][1]['w2']", "['head'][0]", "['odd_k']"}
    for path, leaf in jleaves:
        got = tq
        for key in path:
            got = got[getattr(key, "key", getattr(key, "idx", None))]
        if is_wo(leaf):
            assert isinstance(got, two.WOTensor)
            assert (got.k, got.group, got.bits) == (leaf.k, leaf.group, leaf.bits)
            np.testing.assert_array_equal(got.packed.numpy(), np.asarray(leaf.packed))
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(leaf.scale))
            np.testing.assert_array_equal(two.dequantize_leaf(got).numpy(),
                                          np.asarray(jwo.dequantize_leaf(leaf)))
        else:
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
            assert two.dequantize_leaf(got) is got
    assert isinstance(tq["head"], tuple) and isinstance(tq["blocks"], list)
    assert two.pytree_bytes(tq) == jwo.pytree_bytes(jq)
    assert two.pytree_bytes(tparams) == jwo.pytree_bytes(jparams)
    assert two.pytree_bytes(tq) < two.pytree_bytes(tparams)
