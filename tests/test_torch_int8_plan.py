"""K1 and K2 (``ops/int_matmul.py``) on the CPU: the regime rule, the plan
of what each regime launches, the limits the wrappers raise, and the
wrappers' calls.

The kernels run only on a card (``tests/test_torch_cuda.py``). Here the
grids the wrapper plans are walked with the block orders the kernels use
(``csrc/int_matmul.cu``: the small kernel's 1-D tile index and k32 steps
split over 8 warps, the codes pre-pass's grid-stride units of 4 codes, the
weight pre-pass's 64 x 64 tiles, the GEMM's persistent walk over 128 x 256
tiles in bands of 8 row tiles) to show that every output tile and every k
is taken once; and the wrappers are driven against a stand-in library. No
JAX is needed.
"""

import inspect

import numpy as np
import pytest
import torch

from micronet_tpu_torch.ops import _build
from micronet_tpu_torch.ops import int_matmul as ti8

# (M, K, N): the engine's fc, the large call, K2's path call (NIN-GC's 8th conv at batch 1024),
# the ragged A4 call, and the card tests' shapes
_CALLS = [(512, 512, 10), (8192, 4096, 4096), (65536, 1024, 1024), (333, 200, 19),
          (33, 200, 19), (17, 64, 130), (1000, 1024, 300), (1, 37, 10), (300, 1000, 513),
          (129, 2000, 130), (2000, 256, 130), (1024, 1024, 1024)]
_SMS = (66, 114, 132)


def test_regime_reads_m_k_n_and_the_sm_count_only():
    """The engine's fc and the ragged calls run the small regime, the large
    call and K2's path call the GEMM, on any of these cards; N <= 32 is
    always small."""
    assert list(inspect.signature(ti8._k1_regime).parameters) == ["m", "k", "n", "sms"]
    for sms in _SMS:
        assert ti8._k1_regime(512, 512, 10, sms) == "small"
        assert ti8._k1_regime(333, 200, 19, sms) == "small"
        assert ti8._k1_regime(8192, 4096, 4096, sms) == "gemm"
        assert ti8._k1_regime(65536, 1024, 1024, sms) == "gemm"
        assert ti8._k1_regime(2**20, 4096, 32, sms) == "small"
        assert ti8._k1_regime(1024, 1024, 1024, sms) == "gemm"


@pytest.mark.parametrize("m,k,n", _CALLS)
def test_small_plan_takes_every_output_tile_and_every_k_once(m, k, n):
    """Block t of the small kernel owns rows 16 (t // ntn) .., columns 32 (t
    % ntn) .., ntn = ceil(N / 32); warp w of it the k32 steps w, w + 8, ...:
    over the planned grid every output element and, in each block, every k
    fall to exactly one block and one warp."""
    (grid,) = ti8._plan(m, k, n, "small", 132)["grids"]
    ntn = -(-n // 32)
    seen = np.zeros((-(-m // 16) * 16, ntn * 32), dtype=np.int32)
    for t in range(grid):
        m0, n0 = t // ntn * 16, t % ntn * 32
        seen[m0:m0 + 16, n0:n0 + 32] += 1
    assert (seen[:m, :n] == 1).all()
    steps = -(-k // 32)
    taken = np.zeros(steps * 32, dtype=np.int32)
    for w in range(8):
        for s in range(w, steps, 8):
            taken[32 * s:32 * s + 32] += 1
    assert (taken[:k] == 1).all()


def _gemm_origin(tile, num_m, num_n):
    """The GEMM kernel's tile numbering: bands of 8 row tiles, column tiles
    across a band."""
    band = tile // (8 * num_n)
    first_m = band * 8
    band_m = min(num_m - first_m, 8)
    in_band = tile % (8 * num_n)
    return first_m + in_band % band_m, in_band // band_m


@pytest.mark.parametrize("m,k,n", _CALLS)
@pytest.mark.parametrize("sms", _SMS)
def test_gemm_plan_takes_every_tile_code_and_weight_once(m, k, n, sms):
    """The GEMM regime's three grids: the codes pre-pass's threads (a grid
    stride over units of 4 codes of the (M, Kp) scratch, at most 8,192
    blocks), the weight pre-pass's 64 x 64 tiles of (Kp, N) and the
    persistent GEMM's blocks (tiles b, b + G, ...), each covering its work
    exactly once; every k of a tile is in one of its 128-k stages."""
    plan = ti8._plan(m, k, n, "gemm", sms)
    kp = plan["kp"]
    assert kp % 16 == 0 and kp - 16 < k <= kp
    assert plan["codes"] == (m, kp) and plan["wt"] == (n, kp) and plan["launches"] == 3
    codes_grid, wt_grid, gemm_grid = plan["grids"]
    units = m * kp // 4  # thread i takes units i, i + threads, ...: each once
    assert codes_grid == min(-(-units // 256), 8192)
    assert wt_grid == -(-kp // 64) * -(-n // 64)
    num_m, num_n = -(-m // 128), -(-n // 256)
    assert gemm_grid == min(num_m * num_n, sms)
    seen = np.zeros((num_m, num_n), dtype=np.int32)
    for b in range(gemm_grid):
        for tile in range(b, num_m * num_n, gemm_grid):
            seen[_gemm_origin(tile, num_m, num_n)] += 1
    assert (seen == 1).all()
    assert -(-kp // 128) * 128 >= k


def test_the_int32_bound_on_k():
    """K * 128 * 128 fits int32 up to ``_K_MAX`` = 131,071 and not past it;
    past it every regime's call raises before anything launches."""
    assert ti8._K_MAX == 131071
    assert ti8._K_MAX * 128 * 128 <= 2**31 - 1 < (ti8._K_MAX + 1) * 128 * 128
    ti8.check_limits(1, ti8._K_MAX, 10)
    with pytest.raises(ValueError, match="int32"):
        ti8.check_limits(1, ti8._K_MAX + 1, 10)
    for m, k, n in [(0, 16, 8), (4, 0, 8), (4, 16, 0)]:
        with pytest.raises(ValueError, match="M, K, N > 0"):
            ti8.check_limits(m, k, n)


@pytest.mark.parametrize("m", [65536, 65537, 2**20, 2**22])
def test_grids_are_one_dimensional_past_65535_row_blocks(m):
    """Every grid is a 1-D block count, so M = 65,536 and far beyond (65,535
    row blocks was the first kernel's limit) stays within 2^31 - 1 blocks;
    only codes past 2^31 - 1 units of 4 raise."""
    for regime in ("small", "gemm"):
        grids = ti8._plan(m, 1024, 1024, regime, 132)["grids"]
        assert all(0 < g <= 2**31 - 1 for g in grids)
    assert ti8._plan(m, 1024, 1024, "small", 132)["grids"][0] == -(-m // 16) * 32
    ti8.check_limits(m, 1024, 1024)
    with pytest.raises(ValueError, match="units of 4 codes"):
        ti8.check_limits(2**24, 1024, 10)


def test_cpu_tensors_run_the_twins():
    """On CPU tensors both wrappers return their twins' bits and count no
    launch."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((33, 200)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-128, 128, (200, 19)).astype(np.int8))
    ws = torch.from_numpy(rng.random(19).astype(np.float32))
    b1, b2 = ti8.int8_matmul_dequant.launches, ti8.binary_act_matmul.launches
    assert torch.equal(ti8.int8_matmul_dequant(x, w, ws, 0.05, 3.0),
                       ti8.int8_matmul_dequant_ref(x, w, ws, 0.05, 3.0))
    w3 = w.clamp(-1, 1)
    assert torch.equal(ti8.binary_act_matmul(x, w3, ws), ti8.binary_act_matmul_ref(x, w3, ws))
    assert (ti8.int8_matmul_dequant.launches, ti8.binary_act_matmul.launches) == (b1, b2)


class _Lib:
    """Stand-in for the built library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mn_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.mark.parametrize("m,k,n", [(512, 512, 10), (2048, 1024, 1024), (300, 1000, 513)])
@pytest.mark.parametrize("binary", [False, True])
def test_wrapper_calls_the_regime_entry_once(monkeypatch, m, k, n, binary):
    """On a card tensor the public wrapper calls the entry point of the
    regime ``_k1_regime`` picks, once, with the GEMM's scratch of the
    planned shapes, and counts one launch; the forced calls count none;
    nothing falls back to the twin."""
    lib = _Lib()
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name, sig, defines=(): lib)
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(ti8, "int8_matmul_dequant_ref", lambda *a: pytest.fail("twin ran"))
    monkeypatch.setattr(ti8, "binary_act_matmul_ref", lambda *a: pytest.fail("twin ran"))
    x = torch.zeros((m, k))
    w = torch.zeros((k, n), dtype=torch.int8)
    ws = torch.ones(n)
    fn = ti8.binary_act_matmul if binary else ti8.int8_matmul_dequant
    before = fn.launches
    out = ti8.binary_act_matmul(x, w, ws) if binary else fn(x, w, ws, 0.5, 1.0, -8.0, 7.0)
    assert out.shape == (m, n) and fn.launches == before + 1
    regime = ti8._k1_regime(m, k, n, 132)
    assert len(lib.calls) == 1
    name, args = lib.calls[0]
    kind = "binary_act_matmul" if binary else "int8_matmul_dequant"
    assert name == f"mn_{kind}_{regime}"
    assert args[-1] == 7
    tail = (m, k, n) if binary else (m, k, n, -8.0, 7.0)
    assert args[-1 - len(tail):-1] == tail
    quant = None if binary else (torch.tensor(0.5), torch.tensor(1.0), -8.0, 7.0)
    for call in (ti8._small_call, ti8._gemm_call):
        call(x, w, ws, quant)
    assert fn.launches == before + 1
    assert [c[0] for c in lib.calls[1:]] == [f"mn_{kind}_small", f"mn_{kind}_gemm"]


@pytest.mark.parametrize("m,k,n", [(512, 512, 10), (2048, 1024, 1024)])
def test_a_card_tensor_launches_or_raises(monkeypatch, m, k, n):
    """Both regimes of both wrappers take the kernel path on a card tensor,
    never the twin: without a built kernel the call raises and counts no
    launch."""
    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    _build._cdll.cache_clear()
    x = torch.zeros((m, k))
    w = torch.zeros((k, n), dtype=torch.int8)
    b1, b2 = ti8.int8_matmul_dequant.launches, ti8.binary_act_matmul.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        ti8.binary_act_matmul(x, w, torch.ones(n))
    with pytest.raises(RuntimeError, match="nvcc"):
        ti8.int8_matmul_dequant(x, w, torch.ones(n), 1.0, 0.0)
    for call in (ti8._small_call, ti8._gemm_call):
        with pytest.raises(RuntimeError, match="nvcc"):
            call(x, w, torch.ones(n))
    assert (ti8.int8_matmul_dequant.launches, ti8.binary_act_matmul.launches) == (b1, b2)
