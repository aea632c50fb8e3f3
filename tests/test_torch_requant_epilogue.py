"""The integer engine's one-pass conv epilogue (``ops/requant_epilogue.py``)
against its plain twin, today's chain of PyTorch operations.

CPU cases: the operator runs the twin on CPU tensors, the kernel's own
arithmetic (mirrored in numpy) equals the twin at rounding edges, clamp
limits and past 2^24, ``IntConv2d``'s card epilogue equals its chain,
``torch.export`` keeps the operator (its fake implementation), and the
benchmark's GEMM rule does not count the kernel. Card cases (marked
``cuda``; they skip without a card) hold the kernel to the twin bit for
bit in every mode, and the full-width NIN-GC W4A4 and ResNet-18 W8A8
engines to today's chain and to the CPU engine. The file imports torch and
numpy only (no JAX), so it also runs without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_requant_epilogue.py
"""

import copy

import numpy as np
import pytest
import torch

from micronet_tpu_torch.infer import engine as E
from micronet_tpu_torch.ops import requant_epilogue as R

# (int32 acc, chained, bias): the kernel's modes; an f32 acc is the first layer's
_MODES = [(i, c, b) for i in (True, False) for c in (True, False) for b in (True, False)]


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal dtype, shape and bits (f32 compared as int32, so -0.0 and NaN
    payloads count)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


def _strides(t: torch.Tensor):
    """The strides of the dims longer than 1 (a size-1 dim's stride is free)."""
    return [s for n, s in zip(t.shape, t.stride()) if n > 1]


def _ulps_from_half(t: torch.Tensor) -> torch.Tensor:
    """How many f32 ulps of ``t`` lie between it and the nearest k + 0.5."""
    t64 = t.double()
    half = torch.floor(t64) + 0.5
    ulp = (torch.nextafter(t.abs(), torch.tensor(float("inf"))) - t.abs()).double()
    return (t64 - half).abs() / ulp


def _layer_scales(o: int, gen: torch.Generator, bits: int = 4, ties: bool = False):
    """Per-channel scales as a frozen layer holds them: s_x, w_scale (O,),
    bias (O,), out_scale, qmin, qmax. With ``ties``, powers of two and a
    bias on the grid of 2^-7, so that v / out_scale is exactly half the
    integer acc + j and every other value is a tie k + 0.5 (realistic
    scales leave an int32 acc no value within an ulp of one: its range
    holds a few thousand values)."""
    q = 2 ** (bits - 1)
    if ties:
        return (torch.tensor(2.0 ** -3), torch.full((o,), 2.0 ** -4),
                torch.randint(-64, 65, (o,), generator=gen) * 2.0 ** -7,
                torch.tensor(2.0 ** -6), float(-q), float(q - 1))
    s_x = torch.tensor(0.02 + 0.1 * torch.rand((), generator=gen).item())
    w_scale = torch.rand((o,), generator=gen) * 0.05 + 1e-3
    bias = torch.randn((o,), generator=gen) * 0.3
    out_scale = torch.tensor(0.05 + 0.2 * torch.rand((), generator=gen).item())
    return s_x, w_scale, bias, out_scale, float(-q), float(q - 1)


def _edge_inputs(m: int, o: int, scales, int_acc: bool, bias_on: bool, gen: torch.Generator):
    """(M, O) accumulators for the channels' scales: uniform values whose
    quotients span past the clamp on both sides, then rows of values whose
    v / out_scale lies within one ulp of k + 0.5 (k over the code range and
    one past it, found by search on the CPU), values past 2^24 where the
    cast rounds, the int32 extremes, and zeros (-0.0 too for an f32 acc).
    Made on the CPU."""
    s_x, w_scale, bias, out_scale, qmin, qmax = (t.cpu() if torch.is_tensor(t) else t
                                                 for t in scales)
    b = bias if bias_on else torch.zeros_like(bias)
    sc = s_x * w_scale
    reach = (max(-qmin, qmax) + 3) * out_scale / sc  # |acc| that reaches past the clamp
    u = torch.rand((m, o), generator=gen) * 2 - 1
    if int_acc:
        acc = torch.round(u * reach).to(torch.int32)
    else:
        acc = (u * (max(-qmin, qmax) + 3) * out_scale).to(torch.float32)
    rows = []
    # near-edge rows, per channel: the 8 candidates whose quotient (the twin's own f32 steps)
    # lies nearest an edge k + 0.5; an int32 acc searches its whole range (up to 40,001
    # values), an f32 one the 9 floats around each edge's preimage, k over the codes and one
    # past them
    ks = torch.arange(qmin - 1, qmax + 2, dtype=torch.float64) + 0.5
    for c in range(o):
        if int_acc:
            lim = int(reach[c].item()) + 1
            cand = torch.linspace(-lim, lim, min(2 * lim + 1, 40001), dtype=torch.float64)
            cand = torch.unique(torch.round(cand)).to(torch.int32)
            v = cand.to(torch.float32) * sc[c]
        else:
            up = down = (ks * out_scale.double() - b[c].double()).to(torch.float32)
            cand = [up]
            for _ in range(4):
                up = torch.nextafter(up, torch.tensor(float("inf")))
                down = torch.nextafter(down, torch.tensor(float("-inf")))
                cand += [up, down]
            v = cand = torch.cat(cand)
        if bias_on:
            v = v + b[c]
        rows.append(cand[torch.argsort(_ulps_from_half(v / out_scale))[:8]])
    edge = torch.stack(rows, dim=1)
    big = (2 ** 24 + torch.randint(1, 2 ** 30, (2, o), generator=gen)).to(torch.int32)
    if int_acc:
        special = torch.cat([big, -big, torch.full((1, o), 2 ** 31 - 1, dtype=torch.int32),
                             torch.full((1, o), -2 ** 31, dtype=torch.int32),
                             torch.zeros((1, o), dtype=torch.int32)])
    else:
        special = torch.cat([big.to(torch.float32), -big.to(torch.float32),
                             torch.zeros((1, o)), torch.full((1, o), -0.0),
                             torch.full((1, o), float(qmax + 40) * out_scale.item()),
                             torch.full((1, o), float(qmin - 40) * out_scale.item())])
    return torch.cat([edge, special, acc])


def _kernel_model(acc, s_x, w_scale, bias, out_scale, qmin, qmax, chained):
    """The kernel's steps element by element in numpy f32 (each operation
    rounded once, as ``__fmul_rn``, ``__fadd_rn``, ``__fdiv_rn`` round):
    the sign put back by a select, the clamp by min and max, the cast by
    truncation."""
    f = np.float32
    a = acc.numpy()
    v = a.astype(np.float32)
    if w_scale is not None:
        v = v * (f(s_x.item()) * w_scale.numpy().astype(np.float32))
    if bias is not None:
        v = v + bias.numpy().astype(np.float32)
    if not chained:
        return torch.from_numpy(v.astype(np.float32))
    t = v / f(out_scale.item())
    r = np.floor(np.abs(t) + f(0.5))
    q = np.where(t > 0, r, np.where(t < 0, -r, f(0)))
    q = np.minimum(np.maximum(q, f(qmin)), f(qmax))
    return torch.from_numpy(np.trunc(q).astype(np.int8))


def _case(mode, m, o, seed, ties=False):
    """The operator's arguments in ``mode`` on the CPU: :func:`_edge_inputs`
    under :func:`_layer_scales`."""
    int_acc, chained, bias_on = mode
    gen = torch.Generator().manual_seed(seed)
    scales = _layer_scales(o, gen, ties=ties)
    acc = _edge_inputs(m, o, scales, int_acc, bias_on, gen)
    s_x, w_scale, bias, out_scale, qmin, qmax = scales
    return (acc, s_x, w_scale if int_acc else None, bias if bias_on else None, out_scale, qmin,
            qmax, chained)


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", _MODES)
def test_kernel_arithmetic_equals_the_twin_at_the_edges(mode, ties):
    """The kernel's steps (numpy f32, one rounding each) give the twin's
    bits on values at .5 edges, clamp limits, past 2^24 and at -0.0; the
    near-edge rows do hold values within one ulp of an edge where the
    scales allow it (an f32 acc, or exact ties)."""
    args = _case(mode, 64, 24, seed=1, ties=ties)
    twin = R.requant_epilogue_ref(*args)
    _same_bits(_kernel_model(*args), twin)
    acc, s_x, w_scale, bias, out_scale = args[:5]
    v = acc[:8].to(torch.float32) * (s_x * w_scale) if w_scale is not None else acc[:8]
    v = v + bias if bias is not None else v
    near = int((_ulps_from_half(v / out_scale) <= 1.0).sum())
    assert near >= (0 if mode[0] and not ties else 24)


@pytest.mark.parametrize("mode", _MODES)
def test_operator_runs_the_twin_on_the_cpu(mode):
    """On CPU tensors the operator (and the wrapper) is the twin, bit for
    bit, and counts no launch."""
    args = _case(mode, 40, 12, seed=2)
    before = R.requant_epilogue.launches
    got = R.requant_epilogue(*args)
    op = torch.ops.micronet_tpu_torch.requant_epilogue(*args)
    assert R.requant_epilogue.launches == before
    _same_bits(got, R.requant_epilogue_ref(*args))
    _same_bits(op, got)
    assert got.dtype == (torch.int8 if mode[1] else torch.float32)


# (N, Cin, H, Cout, k, groups, chained, bias): NIN-GC's last conv (10 of a 16-wide GEMM) and
# a grouped and a plain layer, one image with a 1 x 1 output
_CONVS = [(2, 32, 4, 10, 1, 1, True, True), (3, 16, 5, 24, 3, 4, False, True),
          (2, 8, 6, 64, 3, 1, True, False), (1, 8, 1, 12, 1, 1, False, False)]


@pytest.mark.parametrize("n,cin,h,co,k,groups,chained,bias", _CONVS)
def test_conv_card_epilogue_equals_its_chain(n, cin, h, co, k, groups, chained, bias):
    """``IntConv2d``'s card epilogue over the card route's accumulator rows
    (im2col + ``torch._int_mm``, run here on CPU tensors, so the operator
    runs its twin) gives today's chain's bits and strides, for the int32
    GEMM and for the first layer's f32 one."""
    gen = torch.Generator().manual_seed(n * 100 + co)
    w = torch.randint(-7, 8, (co, cin // groups, k, k), dtype=torch.int8, generator=gen)
    scales = _layer_scales(co, gen)
    s_x, w_scale, b, out_scale, qmin, qmax = scales
    conv = E.IntConv2d(w, w_scale, s_x, b if bias else None, (1, 1), (k // 2, k // 2), (1, 1),
                       groups, -8.0, 7.0)
    conv.chained = chained
    conv.out_scale.copy_(out_scale)
    conv.out_qmin, conv.out_qmax = qmin, qmax
    x_q = torch.randint(-8, 8, (n, cin, h, h), dtype=torch.int8, generator=gen)
    acc = conv._int_acc_im2col(x_q)  # an NCHW view of the GEMM's (M, O) int32 rows
    got = conv._epilogue(acc, conv.w_scale)
    want = conv._finish(acc.to(torch.float32) * (s_x * w_scale)[:, None, None])
    _same_bits(got, want)
    assert _strides(got) == _strides(want)
    f32 = (acc.to(torch.float32) * 0.37).contiguous(memory_format=torch.channels_last)
    got, want = conv._epilogue(f32, None), conv._finish(f32)
    _same_bits(got, want)
    assert _strides(got) == _strides(want)


@pytest.mark.parametrize("chained", [True, False])
def test_export_keeps_the_operator(chained):
    """Under ``torch.export`` the fake implementation gives the output's
    shape and dtype (a strided input too); the program calls the operator
    and equals the eager call."""
    args = list(_case((True, chained, True), 20, 10, seed=3))
    wide = torch.zeros((args[0].shape[0], 16), dtype=torch.int32)
    wide[:, :10] = args[0]

    class Epilogue(torch.nn.Module):
        def forward(self, a):
            return R.requant_epilogue(a[:, :10], *args[1:])

    program = torch.export.export(Epilogue(), (wide,), strict=False)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert torch.ops.micronet_tpu_torch.requant_epilogue.default in targets
    out = program.module()(wide)
    _same_bits(out, R.requant_epilogue_ref(*args))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = R.requant_epilogue(mode.from_tensor(wide)[:, :10],
                                  *[mode.from_tensor(a) if torch.is_tensor(a) else a
                                    for a in args[1:]])
    assert fake.shape == out.shape and fake.dtype == out.dtype


def test_kernel_is_no_gemm_to_the_benchmark():
    """The benchmark's GEMM rule (``gemm_roofline_pct.infer``) does not class
    the kernel as a GEMM, and ``engine_fused_epilogues_per_fwd`` counts its
    launches per call (None where a call launches none)."""
    import types

    from portbench import harness

    is_gemm = harness.load_module("layers", "gemm_roofline_pct.infer").is_gemm
    reader = harness.load_module("layers", "engine_fused_epilogues_per_fwd").read
    names = [f"void (anonymous namespace)::requant_epilogue{s}_kernel<{t}, {b}, {c}>"
             f"((anonymous namespace)::Params)" for s in ("", "_scalar")
             for t in ("int", "float") for b in ("true", "false") for c in ("true", "false")]
    assert not any(is_gemm(n) for n in names)
    assert is_gemm("sm90_xmma_gemm_s8s8_s32") and is_gemm("int8_small_kernel<false>")
    kernels = [[n, 1e-4] for n in names[:9]] + [["sm90_xmma_gemm_s8s8_s32", 1e-3]] * 9
    run = types.SimpleNamespace(window={"kind": "infer"},
                                stretch={"kernels": kernels * 5, "steps": 5})
    assert reader(run) == 9
    run.stretch = {"kernels": kernels[9:] * 5, "steps": 5}
    assert reader(run) is None


@pytest.mark.parametrize("m,o", [(1, 4), (17, 12), (65536, 10), (1048576, 256), (4099, 1000),
                                 (300, 4096)])
def test_grid_keeps_each_thread_on_its_channels(m, o):
    """The vector kernel's grid has a multiple of O / 4 threads (so each
    keeps its 4 channels down the rows) and at least one row step; the
    scalar kernel's covers every element with at most 4 blocks an SM."""
    for sms in (1, 132):
        if o % 4 == 0:
            blocks = R._plan(m, o, True, sms)
            assert blocks >= 1 and blocks * R._THREADS % (o // 4) == 0
            assert blocks * R._THREADS // (o // 4) >= 1
        blocks = R._plan(m, o, False, sms)
        assert 1 <= blocks <= max(R._BLOCKS_PER_SM * sms, 1)


def test_wrapper_checks_its_operands():
    """``_check`` raises on an accumulator that is not (M, O) rows with
    unit column stride, on int32 without ``w_scale`` or f32 with it, and on
    a bias or scale of the wrong type or shape."""
    args = list(_case((True, True, True), 8, 8, seed=4))
    R._check(*args[:5])
    R._check(args[0][:, :6], args[1], args[2][:6], args[3][:6], args[4])
    bad = [
        (args[0].t(),) + tuple(args[1:5]),
        (args[0][:, ::2],) + tuple(args[1:5]),
        (args[0][None],) + tuple(args[1:5]),
        (args[0], args[1], None, args[3], args[4]),
        (args[0].to(torch.float32), args[1], args[2], args[3], args[4]),
        (args[0], args[1], args[2].double(), args[3], args[4]),
        (args[0], args[1], args[2], args[3][:4], args[4]),
        (args[0], args[1].reshape(1), args[2], args[3], args[4]),
        (args[0].to(torch.int64),) + tuple(args[1:5]),
    ]
    for b in bad:
        with pytest.raises(ValueError):
            R._check(*b)


# small engines on the CPU: (net, quantization, image size)
_SMALL = {
    "nin_gc_w4a4": ("micronet_tpu_torch.models.nin_gc:Net", dict(a_bits=4, w_bits=4), 32),
    "resnet_w8a8": ("micronet_tpu_torch.models.resnet:ResNet", dict(a_bits=8, w_bits=8), 8),
    "nin_gc_w4a4_asym": ("micronet_tpu_torch.models.nin_gc:Net",
                         dict(a_bits=4, w_bits=4, q_type=1), 32),
}


def _net(path: str, gen: torch.Generator, dev):
    import importlib

    from micronet_tpu_torch.models.resnet import BasicBlock

    mod, fn = path.split(":")
    build = getattr(importlib.import_module(mod), fn)
    if fn == "ResNet":
        return build(BasicBlock, [1, 1, 1, 1], device=dev, generator=gen)
    if dev == "cpu":
        return build(cfg=[64] * 8, device=dev, generator=gen)
    return build(device=dev, generator=gen)


def _frozen(path: str, quant: dict, size: int, batch: int, calib: int, seed: int, dev):
    """The net frozen to the integer engine on ``dev`` from a seed (``calib``
    calibration batches of 64 Gaussian images on the exact f32 path, BN
    folded), and an input batch."""
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = QuantConfig(**quant, bn_fuse=True, act_codes="off", bn_stats="off")
    q = train_mode(prepare(_net(path, gen, dev), cfg, device=dev))
    with torch.no_grad():
        for _ in range(calib):
            q(torch.randn((64, size, size, 3), device=dev, generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=dev))
    x = torch.randn((batch, size, size, 3), device=dev, generator=gen)
    return eval_mode(freeze_int(fused, example_input=x[:1], device=dev)), x


@pytest.fixture(scope="module")
def small_engines():
    return {name: _frozen(path, quant, size, 4, 2, i, "cpu")
            for i, (name, (path, quant, size)) in enumerate(_SMALL.items())}


def _symmetric_convs(eng):
    return [m for m in eng.modules()
            if isinstance(m, E.IntConv2d) and m.symmetric and m.w_symmetric]


@pytest.mark.parametrize("net", list(_SMALL))
def test_engine_takes_the_card_epilogue_where_it_may(small_engines, net, monkeypatch):
    """Every symmetric conv, the first layer's f32 route too, ends in the
    one-pass epilogue's operator once per forward, an asymmetric one
    never; on the card's int32 route (im2col + ``torch._int_mm``, run
    here on CPU tensors, so the operator runs its twin) the logits equal
    the CPU route's bit for bit."""
    eng, x = small_engines[net]
    calls = []
    epilogue = E.IntConv2d._epilogue

    def counted(self, acc, w_scale):
        calls.append(self)
        return epilogue(self, acc, w_scale)

    monkeypatch.setattr(E.IntConv2d, "_epilogue", counted)
    with torch.no_grad():
        want = eng(x)
    convs = _symmetric_convs(eng)
    assert calls == [m for m in eng.modules() if m in convs]
    assert (len(convs) == 0) == net.endswith("asym")
    assert any(m.f32_dequant for m in convs) or not convs
    monkeypatch.setattr(E._IntConvRoutes, "int_acc", E._IntConvRoutes._int_acc_im2col)
    with torch.no_grad():
        got = eng(x)
    _same_bits(got, want)


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the benchmark's two engines at full width: (net, bits, batch, symmetric convs)
_NETS = {"nin_gc_w4a4": ("micronet_tpu_torch.models.nin_gc:Net", 4, 1024, 9),
         "resnet18_w8a8": ("micronet_tpu_torch.models.resnet:resnet18", 8, 512, 20)}


@pytest.fixture(scope="module")
def engines(card):
    """Each net frozen on the card from a seed (4 calibration batches of
    64), with its input batch."""
    return {name: _frozen(path, dict(a_bits=bits, w_bits=bits), 32, batch, 4, 20 + i, card)
            for i, (name, (path, bits, batch, _)) in enumerate(_NETS.items())}


def _layer_cases(engines, card):
    """Scales (s_x, w_scale, bias, out_scale, qmin, qmax) on the card of a
    chained layer of each frozen engine (one of NIN-GC's grouped convs, a
    ResNet-18 block's first conv), and power-of-two scales whose quotients
    hold exact ties (:func:`_layer_scales`)."""
    out = []
    for name, (eng, _) in engines.items():
        convs = [m for m in _symmetric_convs(eng) if m.chained and m.bias is not None
                 and not m.f32_dequant]
        m = convs[len(convs) // 2]
        out.append((name, (m.act_scale, m.w_scale, m.bias, m.out_scale, m.out_qmin, m.out_qmax)))
    ties = _layer_scales(64, torch.Generator().manual_seed(6), ties=True)
    out.append(("ties", tuple(t.to(card) if torch.is_tensor(t) else t for t in ties)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", _MODES)
def test_kernel_equals_twin_bit_for_bit(card, engines, mode):
    """Every mode at frozen NIN-GC W4A4 and ResNet-18 W8A8 layers' scales,
    on rows holding values within one ulp of .5 edges, at and past the
    clamp, past 2^24 and -0.0; full rows (the vector kernel), a [:m, :10]
    slice of 16-wide rows and an [:, 2:10] slice (the scalar kernel), and
    a few short ones: the int8 codes equal, the f32 outputs equal bit for
    bit (on the card and on the CPU), the strides the twin's, one launch a
    call."""
    int_acc, chained, bias_on = mode
    for name, scales in _layer_cases(engines, card):
        s_x, w_scale, bias, out_scale, qmin, qmax = scales
        o = w_scale.shape[0]
        gen = torch.Generator().manual_seed(len(name) + o)
        cpu_scales = (s_x.cpu(), w_scale.cpu(), bias.cpu(), out_scale.cpu(), qmin, qmax)
        rows = _edge_inputs(4099, o, cpu_scales, int_acc, bias_on, gen).to(card)
        for m in (1, 3, rows.shape[0]):
            acc = rows[:m]
            wide = torch.zeros((m, 16), dtype=acc.dtype, device=card)
            wide[:, :10] = acc[:, :10]
            for a, cols in ((acc, slice(None)), (wide[:, :10], slice(0, 10)),
                            (wide[:, 2:10], slice(2, 10))):
                args = (a, s_x, w_scale[cols] if int_acc else None,
                        bias[cols] if bias_on else None, out_scale, qmin, qmax, chained)
                before = R.requant_epilogue.launches
                got = R.requant_epilogue(*args)
                torch.cuda.synchronize()
                assert R.requant_epilogue.launches == before + 1
                want = R.requant_epilogue_ref(*args)
                _same_bits(got, want)
                # (M, O) contiguous; the twin returns its input itself when nothing is
                # left to do (an f32 acc, unchained, no bias)
                assert got.is_contiguous()
                assert want.data_ptr() == a.data_ptr() or got.stride() == want.stride()
                cpu = [t.cpu() if torch.is_tensor(t) else t for t in args]
                _same_bits(got, R.requant_epilogue_ref(*cpu))


@pytest.mark.cuda
def test_captured_kernel_replays_equal_eager(card, engines):
    """The kernel captured in a CUDA graph: the capture counts one launch, a
    replay none, and each replay on new accumulators equals the twin."""
    _, scales = _layer_cases(engines, card)[0]
    s_x, w_scale, bias, out_scale, qmin, qmax = scales
    gen = torch.Generator(device=card).manual_seed(5)
    static = torch.randint(-5000, 5000, (8192, w_scale.shape[0]), dtype=torch.int32,
                           device=card, generator=gen)
    args = (s_x, w_scale, bias, out_scale, qmin, qmax, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        R.requant_epilogue(static, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = R.requant_epilogue.launches
    with torch.cuda.graph(graph):
        out = R.requant_epilogue(static, *args)
    assert R.requant_epilogue.launches == before + 1
    for _ in range(2):
        static.copy_(torch.randint(-5000, 5000, static.shape, dtype=torch.int32, device=card,
                                   generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(out, R.requant_epilogue_ref(static, *args))
    assert R.requant_epilogue.launches == before + 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(card, engines):
    _, scales = _layer_cases(engines, card)[0]
    s_x, w_scale, bias, out_scale, qmin, qmax = scales
    acc = torch.zeros((64, w_scale.shape[0]), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        R.requant_epilogue(acc.t(), s_x, w_scale, bias, out_scale, qmin, qmax, True)
    with pytest.raises(ValueError):
        R.requant_epilogue(acc, s_x, None, bias, out_scale, qmin, qmax, True)
    with pytest.raises(ValueError):
        R.requant_epilogue(acc, s_x.cpu(), w_scale, bias, out_scale, qmin, qmax, True)


@pytest.mark.cuda
def test_deploy_artifact_calls_the_kernel(card, engines):
    """A ``torch.export`` artifact of the ResNet-18 engine on the card: its
    graph calls the operator once per symmetric conv (the fake
    implementation traced it), the loaded program launches the kernel and
    equals the eager engine bit for bit."""
    from micronet_tpu_torch.infer import deserialize_engine, serialize_engine

    eng, x = engines["resnet18_w8a8"]
    run = deserialize_engine(serialize_engine(eng, batch=8))
    op = torch.ops.micronet_tpu_torch.requant_epilogue.default
    assert sum(n.target == op for n in run.program.graph.nodes) == 20
    before = R.requant_epilogue.launches
    with torch.no_grad():
        got = run(x[:8])
        torch.cuda.synchronize()
        assert R.requant_epilogue.launches == before + 20
        _same_bits(got, eng(x[:8]))


def _chain_epilogue(self, acc, w_scale):
    """Today's chain in ``_epilogue``'s place: the parent's f32 cast,
    scale, bias and requant over the NCHW view."""
    if w_scale is not None:
        acc = acc.to(torch.float32) * (self.act_scale * w_scale)[:, None, None]
    return self._finish(acc)


def _record(eng):
    """Hooks that keep each symmetric conv's input and output."""
    seen = {}

    def hook(mod, args, out):
        seen[mod] = (args[0], out)

    return seen, [m.register_forward_hook(hook) for m in _symmetric_convs(eng)]


@pytest.mark.cuda
@pytest.mark.parametrize("net", list(_NETS))
def test_engine_at_full_width_equals_its_chain_and_the_cpu(card, engines, net, monkeypatch):
    """The benchmark's engine at its width and batch: one kernel launch per
    symmetric conv per eager forward (9 on NIN-GC, 20 on ResNet-18); every
    conv's output and the logits equal today's chain on the card bit for
    bit (strides too), and equal the CPU engine's on 64 images, whose
    first layer takes the card's f32 GEMM output (its sums run in another
    order on the CPU; its epilogue is compared); a ``build_engine`` bucket
    replays the eager logits."""
    from micronet_tpu_torch.infer import build_engine

    eng, x = engines[net]
    convs = _symmetric_convs(eng)
    assert len(convs) == _NETS[net][3]
    seen, hooks = _record(eng)
    with torch.no_grad():
        before = R.requant_epilogue.launches
        logits = eng(x)
        torch.cuda.synchronize()
        assert R.requant_epilogue.launches == before + len(convs)
        fused = dict(seen)
        with monkeypatch.context() as mp:
            mp.setattr(E.IntConv2d, "_epilogue", _chain_epilogue)
            chain_logits = eng(x)
            torch.cuda.synchronize()
        assert R.requant_epilogue.launches == before + len(convs)
    for h in hooks:
        h.remove()
    _same_bits(logits, chain_logits)
    for m in convs:
        got, want = fused[m][1], seen[m][1]
        _same_bits(got, want)
        assert _strides(got) == _strides(want)

    rows = 64
    first = next(m for m in convs if m.f32_dequant)
    with torch.no_grad():
        pre = first.dequant_conv(E._act_codes(fused[first][0], first.act_scale,
                                              first.act_zero_point, first.a_qmin, first.a_qmax,
                                              True))
    cpu = copy.deepcopy(eng).to("cpu")
    cpu_convs = _symmetric_convs(cpu)
    cpu_convs[convs.index(first)].dequant_conv = lambda x_q: pre[:rows].cpu()
    seen_cpu, hooks = _record(cpu)
    with torch.no_grad():
        cpu_logits = cpu(x[:rows].cpu())
    for h in hooks:
        h.remove()
    _same_bits(logits[:rows], cpu_logits)
    for m, mc in zip(convs, cpu_convs):
        _same_bits(fused[m][1][:rows], seen_cpu[mc][1])

    compiled = build_engine(eng, profile=(x.shape[0],) * 3, device=card)
    _same_bits(compiled(x), logits)
