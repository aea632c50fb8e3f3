"""K3 (``int4_matmul_grouped_hl8``) on the CPU: its card kernel's bit tricks
mirrored in numpy, its regime choice, and its wrapper's calls.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``); here
the dequantize of both regimes is replayed on every byte pair and held bit
for bit against ``unpack_int4_hl8``, and the wrapper is driven against a
stand-in library to show which entry point and which arguments each call
gets. No JAX is needed.
"""

import inspect

import numpy as np
import pytest
import torch

from micronet_tpu_torch.ops import _build
from micronet_tpu_torch.ops import int4_matmul as tim


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm: result byte i is byte (sel >> 4i) & 7 of (b << 32 | a);
    ``sel`` a scalar or an array."""
    both = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    sel = np.asarray(sel, dtype=np.uint64)
    out = np.zeros_like(a, dtype=np.uint32)
    for i in range(4):
        src = (sel >> np.uint64(4 * i)) & np.uint64(7)
        byte = (both >> (np.uint64(8) * src)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def _minus136(biased):
    """The two bf16 of ``biased`` (128 + c each) minus 136, as f32 (exact)."""
    lo = (biased & np.uint32(0xFFFF)) << np.uint32(16)
    hi = biased & np.uint32(0xFFFF0000)
    return lo.view(np.float32) - np.float32(136.0), hi.view(np.float32) - np.float32(136.0)


def _dq_lo(v):  # dq_hl8_lo_bf16x2
    return _minus136((v & np.uint32(0x000F000F)) | np.uint32(0x43004300))


def _dq_hi(v):  # dq_bf16x2 on the high nibbles
    return _minus136((v & np.uint32(0x000F000F)) ^ np.uint32(0x43084308))


def _hl8_rows(nrows, seed):
    """(nrows, 65536) hl8 bytes, rows 0 and 1 holding every byte pair once, in
    every byte position of a 4-byte word; the other rows random."""
    p0 = np.tile(np.arange(256, dtype=np.uint32), 256)
    p1 = np.roll(np.repeat(np.arange(256, dtype=np.uint32), 256), 1)
    rest = np.random.default_rng(seed).integers(0, 256, (nrows - 2, p0.size), dtype=np.uint32)
    return np.concatenate([np.stack([p0, p1]), rest]).astype(np.uint8).view(np.int8)


def _words(row):
    return np.ascontiguousarray(row).view(np.uint32)  # column 4q + i is byte i


def test_regime_a_dequant_bits_equal_unpack_int4_hl8_on_every_byte():
    """Regime A (the w4 kernel's hl8 mode), bit for bit: a byte permute puts
    columns (2j, 2j + 1) of packed rows 0 and 1 side by side; the low nibbles
    (v = t, t >> 8) go through (v & 0x000F000F) | 0x43004300 and the high
    nibbles (v = t >> 4, t >> 12) through ^ 0x43084308, each minus 136: the
    codes of unpack_int4_hl8, both halves, on every byte pair."""
    packed = _hl8_rows(2, seed=0)
    codes = tim.unpack_int4_hl8(torch.from_numpy(packed)).numpy().astype(np.float32)
    lo_ref, hi_ref = codes[:2], codes[2:]
    w0, w1 = _words(packed[0]), _words(packed[1])
    for j in range(2):  # the word's columns (0, 1) and (2, 3)
        t = _byte_perm(w0, w1, 0x7632 if j else 0x5410)
        for shift, dq, half, e in ((0, _dq_lo, lo_ref, 0), (8, _dq_lo, lo_ref, 1),
                                   (4, _dq_hi, hi_ref, 0), (12, _dq_hi, hi_ref, 1)):
            for r, q in enumerate(dq(t >> np.uint32(shift))):
                np.testing.assert_array_equal(q, half[r, 2 * j + e::4])


@pytest.mark.parametrize("half", [0, 1])
def test_regime_b_fragment_bits_equal_unpack_int4_hl8_on_every_byte(half):
    """Regime B's dequantize into wgmma's register fragment, bit for bit: a
    thread reads the 16-bit pair of columns (c0, c0 + 1) of packed rows 2t
    and 2t + 1; __byte_perm(u0, u1, 0x4400) puts column c0 of both rows at
    bits 0-7 and 16-23, 0x5511 column c0 + 1; the nibble dequantize of
    ``half`` then gives the fragment register (k = 2t, 2t + 1) of each
    column: the codes of unpack_int4_hl8 on every byte pair, in either
    column of the pair."""
    packed = _hl8_rows(2, seed=half + 1)
    codes = tim.unpack_int4_hl8(torch.from_numpy(packed)).numpy().astype(np.float32)
    ref = codes[2 * half:2 * half + 2]  # rows 2t, 2t + 1 of the half
    u8 = packed.view(np.uint8).astype(np.uint32)
    u0 = u8[0, 0::2] | (u8[0, 1::2] << np.uint32(8))  # little-endian 16-bit loads at even c0
    u1 = u8[1, 0::2] | (u8[1, 1::2] << np.uint32(8))
    for sel, e in ((0x4400, 0), (0x5511, 1)):
        v = _byte_perm(u0, u1, sel)
        lo, hi = _dq_hi(v >> np.uint32(4)) if half else _dq_lo(v)
        np.testing.assert_array_equal(lo, ref[0, e::2])
        np.testing.assert_array_equal(hi, ref[1, e::2])


def test_regime_reads_only_m_and_group():
    """The regime is a function of M and the group alone (never x, N or the
    card): A up to 128 batch rows and for any group that is not a multiple
    of 16 rows, B past 128 rows."""
    assert list(inspect.signature(tim._k3_regime).parameters) == ["m", "group"]
    for group in (16, 32, 48, 64, 128, 256):
        assert [tim._k3_regime(m, group) for m in (1, 8, 127, 128, 129, 6000)] == \
            ["A"] * 4 + ["B"] * 2
    for group in (1, 11, 20, 50, 100):
        assert {tim._k3_regime(m, group) for m in (1, 128, 129, 6000)} == {"A"}


class _Lib:
    """Stand-in for the built library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mn_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.mark.parametrize("m,k,n,group,regime", [
    (1, 256, 64, 128, "A"), (8, 4096, 4096, 128, "A"), (128, 512, 100, 64, "A"),
    (129, 512, 128, 64, "B"), (300, 672, 136, 48, "B"), (300, 1000, 400, 50, "A")])
def test_wrapper_calls_the_regime_entry_with_its_workspaces(monkeypatch, m, k, n, group, regime):
    """On a card tensor the wrapper calls regime A's entry point (the w4
    kernel, with K8/K9's split and batch-tile rules and kept workspace) or
    regime B's (a bf16 scratch of two (Mp, K/2) planes, Mp = M rounded up to
    128), once, and counts one launch; nothing falls back to the twin."""
    lib = _Lib()
    monkeypatch.setattr(tim, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name, sig, defines=(): lib)
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(tim, "_W4_WORKSPACE", {})
    monkeypatch.setattr(tim, "_W4_COUNTERS", {})
    scratch = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: scratch.append((a, kw)) or empty(*a, **kw))
    monkeypatch.setattr(tim, "int4_matmul_grouped_hl8_ref", lambda *a: pytest.fail("twin ran"))
    x = torch.zeros((m, k))
    packed = torch.zeros((k // 2, n), dtype=torch.int8)
    gs = torch.ones((k // group, n))
    before = tim.int4_matmul_grouped_hl8.launches
    out = tim.int4_matmul_grouped_hl8(x, packed, gs)
    assert out.shape == (m, n) and tim.int4_matmul_grouped_hl8.launches == before + 1
    assert len(lib.calls) == 1
    name, args = lib.calls[0]
    if regime == "A":
        assert name == "mn_int4_matmul_grouped_hl8"
        splits = tim._w4_splits(k // 2, n, 132)
        assert args[6:] == (m, k, n, group, splits, 1 if m <= 8 else 2, 7)
        assert (args[4] is None) == (splits == 1)
    else:
        assert name == "mn_int4_matmul_grouped_hl8_gemm"
        assert args[5:] == (m, k, n, group, 7)
        mp = -(-m // 128) * 128
        assert any(a == (2 * mp * (k // 2),) and kw.get("dtype") == torch.bfloat16
                   for a, kw in scratch)


def test_split_cols_sets_regime_a_split_only(monkeypatch):
    """A column shard given the whole weight's N (``split_cols``, what
    ``parallel.shard_state`` sets on a ``WOLinear``) gets the whole call's
    K-split in regime A; a narrower ``split_cols`` than N raises."""
    lib = _Lib()
    monkeypatch.setattr(tim, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name, sig, defines=(): lib)
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(tim, "_W4_WORKSPACE", {})
    monkeypatch.setattr(tim, "_W4_COUNTERS", {})
    k, n, group = 4096, 3072, 128
    x = torch.zeros((8, k))
    packed = torch.zeros((k // 2, n), dtype=torch.int8)
    gs = torch.ones((k // group, n))
    tim.int4_matmul_grouped_hl8(x, packed, gs)
    tim.int4_matmul_grouped_hl8(x, packed, gs, split_cols=2 * n)
    own, whole = (args[10] for _, args in lib.calls)
    assert (own, whole) == (tim._w4_splits(k // 2, n, 132), tim._w4_splits(k // 2, 2 * n, 132))
    assert own != whole
    with pytest.raises(ValueError, match="narrower"):
        tim.int4_matmul_grouped_hl8(x, packed, gs, split_cols=n - 4)


@pytest.mark.parametrize("m", [4, 300])
def test_wrapper_on_a_card_tensor_launches_or_raises(monkeypatch, m):
    """Either regime on a card tensor takes the kernel path, never the twin:
    without a built kernel the call raises and counts no launch."""
    monkeypatch.setattr(tim, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    _build._cdll.cache_clear()
    x = torch.zeros((m, 64))
    before = tim.int4_matmul_grouped_hl8.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tim.int4_matmul_grouped_hl8(x, torch.zeros((32, 8), dtype=torch.int8),
                                    torch.ones((4, 8)))
    assert tim.int4_matmul_grouped_hl8.launches == before
