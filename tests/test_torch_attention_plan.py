"""Decode attention's wrappers on the CPU: the plan they hand the card
kernels (``ops/decode_attention.py::_plan``: the regime, the cluster size
and the longest slice, from S alone), the slice rule the kernel cuts each
group by, ``check_limits``, and the call each wrapper makes, driven against
a stand-in library. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``). No JAX is needed.
"""

import inspect

import pytest
import torch

from micronet_tpu_torch.ops import _build
from micronet_tpu_torch.ops import decode_attention as tda
from micronet_tpu_torch.ops import paged_attention as tpa


def test_plan_reads_only_s():
    """The regime, the cluster size and the longest slice come from S
    alone: the cluster regime up to 16,384, in clusters of 8 blocks (the
    portable maximum) with slices that cover S + 1 positions (a full cache
    and the current row), the split regime past it."""
    assert list(inspect.signature(tda._plan).parameters) == ["s"]
    for s in (1, 16, 255, 300, 2048, 4096, 4097, 5000, 8192, tda._MAX_CLUSTER_S):
        c, lmax = tda._plan(s)
        assert c == tda._CLUSTER == 8
        assert lmax == tda.slice_len(s + 1, c)
        assert lmax % 16 == 0 and lmax * c >= s + 1
    for s in (tda._MAX_CLUSTER_S + 1, 20000, 131072):
        assert tda._plan(s) == (0, 0)


@pytest.mark.parametrize("c", [1, 4, 8, 16])
def test_slice_rule_covers_every_count_within_the_plan(c):
    """For every visible count n the c blocks' slices (a multiple of 16
    each, growing with n) hold all n positions, one MMA tile short of an
    even cut at most, and never exceed the longest slice the wrapper sized
    shared memory for."""
    s = 1200
    lmax = tda.slice_len(s + 1, c)
    prev = 0
    for n in range(s + 2):
        sl = tda.slice_len(n, c)
        assert sl % 16 == 0 and prev <= sl <= lmax
        assert c * sl >= n and sl < -(-n // c) + 16
        prev = sl
    assert tda.slice_len(0, c) == 0


@pytest.mark.parametrize("s,d,r", [(0, 128, 4), (64, 130, 4), (64, 6, 4), (64, 128, 0),
                                   (64, 128, 9), (64, 0, 1)])
def test_check_limits_raises_on_what_the_kernels_cannot_take(s, d, r):
    with pytest.raises(ValueError, match="kernel needs"):
        tda.check_limits(s, d, r)


@pytest.mark.parametrize("s,d,r", [(1, 4, 1), (2048, 128, 4), (16384, 128, 8), (100000, 36, 8)])
def test_check_limits_takes_every_s(s, d, r):
    tda.check_limits(s, d, r)


class _Lib:
    """Stand-in for the built library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mn_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors taken for card tensors, a stand-in library, and a record
    of every torch.empty; the twins must not run."""
    lib = _Lib()
    for mod in (tda, tpa):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name, sig, defines=(): lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    for name in ("decode_attend_q8kv_ref", "decode_attend_q8kv_cur_ref",
                 "decode_attend_q8kv_blocked_ref", "decode_attend_q8kv_blocked_cur_ref"):
        monkeypatch.setattr(tda, name, lambda *a: pytest.fail("twin ran"))
    empties = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: empties.append((a, kw))
                        or empty(*a, **kw))
    return lib, empties


def _dense(g, s, d, r):
    kc = torch.zeros((g, s, d), dtype=torch.int8)
    sc = torch.ones((g, s))
    cur = (torch.zeros((g, d), dtype=torch.int8), torch.ones(g),
           torch.zeros((g, d), dtype=torch.int8), torch.ones(g))
    return (kc, sc, kc, sc, torch.zeros((g, r, d))), cur


@pytest.mark.parametrize("s", [300, 2048, 4097, 8192, 16400])
def test_dense_wrappers_hand_the_kernel_the_plan_of_s(card, s):
    """Every dense wrapper, at any batch and bounds, calls the kernel once
    with S's plan: in the cluster regime no scratch is allocated (only the
    output), in the split regime one scratch of split_scratch_floats."""
    lib, empties = card
    d, r = 8, 2
    cluster, lmax = tda._plan(s)
    fns = [(tda.decode_attend_q8kv_cur, True), (tda.decode_attend_q8kv, False),
           (tda.decode_attend_q8kv_blocked_cur, True), (tda.decode_attend_q8kv_blocked, False)]
    for g, bounds in ((1, [s]), (3, [0, 1, s // 2])):
        base, cur = _dense(g, s, d, r)
        bound = torch.tensor(bounds, dtype=torch.int32)
        for fn, has_cur in fns:
            counted = (fn if s <= tda._MAX_RESIDENT_S or "blocked" in fn.__name__ else
                       getattr(tda, fn.__name__.replace("q8kv", "q8kv_blocked")))
            before = counted.launches
            del lib.calls[:], empties[:]
            out = fn(*base, bound, *cur) if has_cur else fn(*base, bound)
            assert out.shape == (g, r, d) and counted.launches == before + 1
            assert [name for name, _ in lib.calls] == ["mn_decode_attend_q8kv"]
            args = lib.calls[0][1]
            assert args[13:] == (g, s, d, r, int(has_cur), cluster, lmax, 7)
            if cluster:
                assert args[11:13] == (0, 0) and len(empties) == 1  # the output only
            else:
                n = tda.split_scratch_floats(g, s, d, r)
                assert args[12] == n and any(a == ((n,),) for a, _ in empties)


@pytest.mark.parametrize("page,mp", [(16, 8), (16, 128), (16, 512), (512, 16), (7, 40),
                                     (16, 1040)])
def test_paged_wrappers_hand_the_kernel_the_plan_of_s(card, page, mp):
    """K6 and K7 call the paged kernel once with the plan of S = MP * page,
    whatever the slots and lengths."""
    lib, empties = card
    s = page * mp
    cluster, lmax = tda._plan(s)
    h, r, d = 2, 4, 8
    for slots, lengths in ((1, [s]), (3, [0, 5, s])):
        pool = (torch.zeros((4, h, page, d), dtype=torch.int8), torch.ones((4, h, 1, page)))
        table = torch.zeros((slots, mp), dtype=torch.int32)
        q = torch.zeros((slots, h, r, d))
        cur = (torch.zeros((slots, h, d), dtype=torch.int8), torch.ones((slots, h)),
               torch.zeros((slots, h, d), dtype=torch.int8), torch.ones((slots, h)))
        ln = torch.tensor(lengths, dtype=torch.int32)
        for fn, extra in ((tpa.paged_decode_attend_cur, cur), (tpa.paged_decode_attend, ())):
            before = fn.launches
            del lib.calls[:], empties[:]
            out = fn(*pool, *pool, table, ln, q, *extra)
            assert out.shape == (slots, h, r, d) and fn.launches == before + 1
            assert [name for name, _ in lib.calls] == ["mn_paged_decode_attend"]
            args = lib.calls[0][1]
            assert args[14:] == (slots, h, page, mp, d, r, int(bool(extra)), cluster, lmax, 7)
            assert (args[12:14] == (0, 0)) == bool(cluster)
            assert len(empties) == (1 if cluster else 2)


def test_attention_wrappers_on_a_card_tensor_launch_or_raise(monkeypatch):
    """A card tensor takes the kernel path, never the twin: without a built
    kernel each call raises and counts no launch."""
    for mod in (tda, tpa):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    _build._cdll.cache_clear()
    base, cur = _dense(2, 64, 8, 2)
    bound = torch.tensor([3, 64], dtype=torch.int32)
    before = tda.decode_attend_q8kv_cur.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tda.decode_attend_q8kv_cur(*base, bound, *cur)
    assert tda.decode_attend_q8kv_cur.launches == before
    pool = (torch.zeros((3, 2, 16, 8), dtype=torch.int8), torch.ones((3, 2, 1, 16)))
    before = tpa.paged_decode_attend.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tpa.paged_decode_attend(*pool, *pool, torch.zeros((1, 4), dtype=torch.int32),
                                torch.tensor([9], dtype=torch.int32), torch.zeros((1, 2, 2, 8)))
    assert tpa.paged_decode_attend.launches == before

