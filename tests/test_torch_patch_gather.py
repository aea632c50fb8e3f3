"""The integer engine's patch gathers (``ops/patch_gather.py``): the conv's
patch matrix and the int8 channel shuffle, against their plain twins.

CPU cases: the twins equal independent definitions (``torch``'s own
``unfold`` put in (kh, kw, c) column order; the shuffle's permutation as
an index) at every conv and shuffle shape of NIN-GC, ResNet-18 and
MobileNetV2 at batch 2, a stride-2 1 x 1 conv, dilation 2 (the transposed
route) and C = 3 or 10 (the scalar path); the kernels' own index
arithmetic, mirrored thread by thread over the wrappers' grids, gives the
twins' bytes; ``channel_shuffle`` keeps float tensors (and CPU ones) on
its reshape and transpose; the engine's ``_im2col`` keeps a stride-1 1 x 1
conv's view; ``torch.export`` keeps both operators; the benchmark's
readers count the kernels and class none as a GEMM or a convolution.
Card cases (marked ``cuda``; they skip without a card) hold the kernels to
their twins byte for byte at those shapes at batch 2 and at the cells'
batches, at 1- and 4-byte offsets, in a captured CUDA graph and in the f32
variant bit for bit, and the full-width engines to the parent's route
(the twins in the kernels' place) bit for bit, with 9, 20 and 1 launches
an eager forward. The file imports torch only (no JAX), so it also runs
without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_patch_gather.py
"""

import math
import types

import pytest
import torch
import torch.nn.functional as TF

from micronet_tpu_torch.infer import engine as E
from micronet_tpu_torch.nn import functional as F
from micronet_tpu_torch.ops import patch_gather as PG

# (C, H, kernel, stride, padding, dilation, f32) of the patch matrices the three nets' engines
# at 32 x 32 build, each shape once: NIN-GC's stem (5 x 5, f32) and its grouped 3 x 3 convs,
# ResNet-18's and MobileNetV2's 3 x 3 stem (f32), ResNet-18's 3 x 3 convs and stride-2 1 x 1
# shortcuts; then the transposed route's dilated input, and C = 3 or 10 as int8 codes (the
# scalar path)
NET_PATCHES = [
    (3, 32, 5, 1, 2, 1, True), (256, 16, 3, 1, 1, 1, False), (512, 8, 3, 1, 1, 1, False),
    (3, 32, 3, 1, 1, 1, True), (64, 32, 3, 1, 1, 1, False), (64, 32, 3, 2, 1, 1, False),
    (128, 16, 3, 1, 1, 1, False), (128, 16, 3, 2, 1, 1, False), (256, 8, 3, 1, 1, 1, False),
    (256, 8, 3, 2, 1, 1, False), (512, 4, 3, 1, 1, 1, False), (64, 32, 1, 2, 0, 1, False),
    (128, 16, 1, 2, 0, 1, False), (256, 8, 1, 2, 0, 1, False),
]
EXTRA_PATCHES = [(6, 9, 3, 1, 0, 2, False), (10, 7, 3, 1, 1, 1, False), (3, 8, 3, 2, 1, 1, False),
                 (20, 6, 2, 1, 1, 1, False), (16, 5, 1, 1, 1, 1, False)]
# (C, H, groups) of NIN-GC's six shuffles at 32 x 32; then shapes off the tiled path
NET_SHUFFLES = [(256, 32, 2), (256, 16, 2), (512, 16, 16), (512, 16, 4), (512, 8, 4),
                (1024, 8, 32)]
EXTRA_SHUFFLES = [(12, 5, 3), (40, 3, 8), (48, 4, 6)]


def _codes(n: int, c: int, h: int, seed: int, dev="cpu") -> torch.Tensor:
    """int8 codes (N, C, H, H) as the engine hands them on: an NCHW view of
    NHWC rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-128, 128, (n, h, h, c), dtype=torch.int8, device=dev, generator=gen)
    return x.permute(0, 3, 1, 2)


def _geometry(k, s, p, d):
    return (k, k), (s, s), (p, p), (d, d)


def _scale(dev="cpu") -> torch.Tensor:
    return torch.tensor(0.0173, device=dev)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal dtype, shape and bits (f32 compared as int32)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


def _unfold_ref(x: torch.Tensor, kernel, stride, padding, dilation) -> torch.Tensor:
    """An independent patch matrix: ``TF.unfold`` (its columns in (c, kh,
    kw) order) reordered to (kh, kw, c), on f64 values."""
    n, c = x.shape[:2]
    cols = TF.unfold(x.to(torch.float64), kernel, dilation, padding, stride)  # (N, C*kh*kw, L)
    kh, kw = kernel
    cols = cols.reshape(n, c, kh * kw, -1).permute(0, 3, 2, 1)  # (N, L, kh*kw, C)
    return cols.reshape(-1, kh * kw * c)


@pytest.mark.parametrize("c,h,k,s,p,d,f32", NET_PATCHES + EXTRA_PATCHES)
def test_twin_equals_an_independent_patch_matrix(c, h, k, s, p, d, f32):
    """At every shape the twin (through the operator on CPU tensors)
    equals ``TF.unfold``'s patches in (kh, kw, c) order: codes, or for the
    f32 variant ``float(code) * scale`` bit for bit; contiguous."""
    x = _codes(2, c, h, seed=c + h)
    geo = _geometry(k, s, p, d)
    scale = _scale() if f32 else None
    got = PG.patch_matrix(x, *geo, scale=scale)
    ref = _unfold_ref(x, *geo)
    assert got.is_contiguous() and got.shape == ref.shape
    if f32:
        _same_bits(got, (ref.to(torch.int8).to(torch.float32) * scale))
    else:
        assert got.dtype == torch.int8 and torch.equal(got.to(torch.float64), ref)
    _same_bits(got, PG.patch_matrix_ref(x, *geo, scale=scale))


def _matrix_mirror(x: torch.Tensor, kernel, stride, padding, dilation, scale, vec: int,
                   blocks: int) -> torch.Tensor:
    """``patch_matrix_kernel``'s arithmetic thread by thread: each of the
    grid's threads keeps its chunk ``col`` of a row (``vec`` columns: the
    bytes of one tap's channels, or the f32 variant's columns, each of its
    own tap) and walks rows ``r0``, ``r0 + rows``, ...; each column takes
    its input pixel from its tap and the row's (n, oy, ox) as the kernel
    does, or zero. Fails if any (row, chunk) is written twice or never."""
    xh = x.permute(0, 2, 3, 1).contiguous()
    n, h, w, c = xh.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = PG.out_hw(h, w, kernel, stride, padding, dilation)
    k = kh * kw * c
    m, cpr = n * ho * wo, -(-k // vec)
    threads = blocks * PG._THREADS
    assert threads % cpr == 0
    t = torch.arange(threads)
    col, r0, rows = t % cpr, t // cpr, threads // cpr
    steps = max(1, -(-m // rows))
    r = (r0[None, :] + rows * torch.arange(steps)[:, None]).reshape(-1)
    col = col.repeat(steps)
    keep = r < m
    r, col = r[keep], col[keep]
    written = torch.bincount(r * cpr + col, minlength=m * cpr)
    assert torch.equal(written, torch.ones_like(written))
    j = col[:, None] * vec + torch.arange(vec)[None, :]  # each chunk's columns
    valid = j < k
    tap = j // c
    ci = j - tap * c
    ki = tap // kw
    kj = tap - ki * kw
    nn_ = (r // (ho * wo))[:, None]
    rem = (r % (ho * wo))[:, None]
    oy = rem // wo
    iy = oy * sh + ki * dh - ph
    ix = (rem - oy * wo) * sw + kj * dw - pw
    inside = valid & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    at = ((nn_ * h + iy.clamp(0, h - 1)) * w + ix.clamp(0, w - 1)) * c + ci
    src = xh.reshape(-1)[at]
    if scale is not None:
        src = src.to(torch.float32) * scale
    out = torch.zeros(m * k, dtype=src.dtype)
    dst = (r[:, None] * k + j)[valid]
    out[dst] = torch.where(inside, src, torch.zeros_like(src))[valid]
    return out.reshape(m, k)


@pytest.mark.parametrize("c,h,k,s,p,d,f32", NET_PATCHES + EXTRA_PATCHES)
def test_kernel_arithmetic_gives_the_twins_bytes(c, h, k, s, p, d, f32):
    """The patch kernel's index arithmetic over the grid the wrapper plans
    (for a card that holds 792 blocks at once and one that holds 2, at
    every chunk width the shape allows) covers every output chunk once and
    gives the twin's bytes."""
    x = _codes(2, c, h, seed=c * 3 + h)
    geo = _geometry(k, s, p, d)
    scale = _scale() if f32 else None
    want = PG.patch_matrix_ref(x, *geo, scale=scale)
    vecs = [PG._F32_COLUMNS] if f32 else [v for v in (16, 4, 1) if c % v == 0]
    for vec in vecs:
        cpr = -(-k * k * c // vec)
        for slots in (792, 2):
            blocks = PG._plan(want.shape[0] * cpr, cpr, slots)
            _same_bits(_matrix_mirror(x, *geo, scale, vec, blocks), want)


def test_plan_keeps_each_thread_on_its_chunk():
    """The grid's thread count is a multiple of the chunks of a row; it
    holds a thread a chunk where that fits in one wave, and otherwise one
    wave rounded down to whole steps of the grid (one step at least)."""
    for cpr in (1, 27, 36, 75, 144, 288, 4608, 9009):
        step = cpr // math.gcd(cpr, PG._THREADS)
        for units in (1, 100, 10**6, 10**9):
            for slots in (2, 792, 1056):
                blocks = PG._plan(units, cpr, slots)
                assert blocks % step == 0 and blocks * PG._THREADS % cpr == 0
                assert blocks <= max(slots, step)
                assert blocks * PG._THREADS >= units or blocks > slots - step


def test_vector_width_follows_channels_and_alignment():
    base = torch.zeros(64, dtype=torch.int8)
    assert PG._vec(256, base) == 16 and PG._vec(256, base[4:]) == 4
    assert PG._vec(256, base[1:]) == 1 and PG._vec(12, base) == 4 and PG._vec(3, base) == 1


def _shuffle_index_ref(x: torch.Tensor, g: int) -> torch.Tensor:
    """The shuffle as the JAX package defines it: output channel ``k * g +
    r`` is input channel ``r * (C / g) + k``, by an index."""
    c = x.shape[1]
    j = torch.arange(c)
    return x[:, (j % g) * (c // g) + j // g]


def _shuffle_mirror(x: torch.Tensor, g: int, tiled: bool, blocks: int) -> torch.Tensor:
    """``patch_shuffle_kernel``'s arithmetic: with ``tiled``, tiles of whole
    pixel rows, each thread's 16 output bytes from one division and the
    stepped, wrapped source offset; without, each thread's output channel
    and its source offset kept down the pixels. Fails if a byte is
    written twice or never."""
    xh = x.permute(0, 2, 3, 1).contiguous()
    c = xh.shape[3]
    flat = xh.reshape(-1)
    pixels, cg = flat.numel() // c, c // g
    out = torch.zeros_like(flat)
    seen = torch.zeros(flat.numel(), dtype=torch.long)
    if tiled:
        per, chunks_px = PG._TILE_BYTES // c, c // 16
        for t in range(-(-pixels // per)):
            p0 = t * per
            q = torch.arange(min(per, pixels - p0) * chunks_px)
            px = q // chunks_px
            j0 = (q - px * chunks_px) * 16
            k = j0 // g
            r = j0 - k * g
            at = px * c + r * cg + k
            for i in range(16):
                dst = p0 * c + q * 16 + i
                out[dst] = flat[p0 * c + at]
                seen[dst] += 1
                r = r + 1
                wrap = r == g
                r = torch.where(wrap, torch.zeros_like(r), r)
                at = at + torch.where(wrap, torch.full_like(at, 1 - (g - 1) * cg),
                                      torch.full_like(at, cg))
    else:
        threads = blocks * PG._THREADS
        assert threads % c == 0
        first = torch.arange(threads)
        j = first % c
        src = (j % g) * cg + j // g
        px = first // c
        while True:
            live = px < pixels
            if not live.any():
                break
            dst = px[live] * c + j[live]
            out[dst] = flat[px[live] * c + src[live]]
            seen[dst] += 1
            px = px + threads // c
    assert torch.equal(seen, torch.ones_like(seen))
    return out.reshape(xh.shape).permute(0, 3, 1, 2)


@pytest.mark.parametrize("c,h,g", NET_SHUFFLES + EXTRA_SHUFFLES)
def test_shuffle_twin_and_kernel_arithmetic(c, h, g):
    """The twin equals the shuffle's index definition; the tiled kernel's
    arithmetic (where C allows it) and the per-byte kernel's, over the
    wrapper's grids, give its bytes; the operator on CPU tensors returns
    them as an NCHW view of NHWC memory."""
    x = _codes(2, c, h, seed=c + g)
    want = PG.patch_shuffle_ref(x, g)
    assert torch.equal(want, _shuffle_index_ref(x, g)) and want.is_contiguous()
    if c % 16 == 0:
        assert torch.equal(_shuffle_mirror(x, g, True, 0), want)
    for slots in (792, 2):
        blocks = PG._plan(2 * h * h * c, c, slots)
        assert torch.equal(_shuffle_mirror(x, g, False, blocks), want)
    got = PG.patch_shuffle(x, g)
    assert torch.equal(got, want) and got.permute(0, 2, 3, 1).is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_channel_shuffle_keeps_other_tensors_on_its_reshape(dtype, monkeypatch):
    """Float tensors (the QAT step's shuffles) and any CPU tensor keep the
    reshape and transpose: NCHW-contiguous out, the index definition's
    values, the kernel's wrapper never called."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(F, "patch_shuffle", refuse)
    x = _codes(2, 48, 5, seed=3).to(dtype)
    y = F.channel_shuffle(x, 4)
    assert y.dtype == dtype and y.is_contiguous()
    assert torch.equal(y, _shuffle_index_ref(x, 4))


def test_nhwc_codes_copy_only_what_is_not_nhwc():
    """The wrappers read NHWC memory: an NHWC-backed input as a view, any
    other (NCHW memory, a strided slice) as one NHWC copy; non-int8 or
    non-4-d input raises."""
    x = _codes(2, 16, 5, seed=1)
    assert PG._nhwc_codes(x).data_ptr() == x.data_ptr()
    nchw = x.contiguous()
    copied = PG._nhwc_codes(nchw)
    assert copied.is_contiguous() and torch.equal(copied, x.permute(0, 2, 3, 1))
    geo = _geometry(3, 1, 1, 1)
    assert torch.equal(PG.patch_matrix(nchw, *geo), PG.patch_matrix(x, *geo))
    with pytest.raises(ValueError):
        PG._nhwc_codes(x.to(torch.float32))
    with pytest.raises(ValueError):
        PG._nhwc_codes(x[0])


def _conv(c: int, o: int, k: int, stride: int, padding: int, groups: int = 1) -> E.IntConv2d:
    gen = torch.Generator().manual_seed(c + o + k)
    w = torch.randint(-7, 8, (o, c // groups, k, k), dtype=torch.int8, generator=gen)
    return E.IntConv2d(w, torch.rand(o, generator=gen) * 1e-2 + 1e-3, torch.tensor(0.02), None,
                       (stride, stride), (padding, padding), (1, 1), groups, -8.0, 7.0)


@pytest.mark.parametrize("k,stride,padding,view", [(1, 1, 0, True), (1, 2, 0, False),
                                                   (3, 1, 1, False), (3, 2, 1, False)])
def test_engine_im2col_takes_the_operator_where_no_view_does(k, stride, padding, view,
                                                             monkeypatch):
    """``_im2col`` gives a stride-1 1 x 1 conv's codes as a view (no
    operator call) and every other conv's patch matrix through the
    operator, inside the span ``int.im2col``; the card's int32 route over
    it (run here on CPU tensors) equals the CPU route's exact
    accumulator."""
    from micronet_tpu_torch.utils import profiling

    calls = []
    op = PG.patch_matrix

    def counted(*a, **kw):
        calls.append(a)
        return op(*a, **kw)

    monkeypatch.setattr(E, "patch_matrix", counted)
    conv = _conv(32, 8, k, stride, padding)
    x = _codes(2, 32, 7, seed=k + stride)
    profiling.take_spans()
    with profiling.spans_on():
        cols, (n, ho, wo) = conv._im2col(x)
    records, _ = profiling.take_spans()
    assert [r.name for r in records] == ["int.im2col"]
    assert (cols.data_ptr() == x.data_ptr()) == view and len(calls) == (0 if view else 1)
    _same_bits(cols, PG.patch_matrix_ref(x, (k, k), (stride, stride), (padding, padding), (1, 1)))
    acc = conv._int_acc_im2col(x)
    assert torch.equal(acc.to(torch.float64), conv.int_acc(x))


def test_export_keeps_both_operators():
    """Under ``torch.export`` the fake implementations give the outputs'
    shapes and dtypes; the program calls both operators and equals the
    eager calls."""
    scale = _scale()

    class Net(torch.nn.Module):
        def forward(self, a):
            s = PG.patch_shuffle(a, 4)
            return (PG.patch_matrix(s, (3, 3), (2, 2), (1, 1), (1, 1)),
                    PG.patch_matrix(a[:, :3], (3, 3), (1, 1), (1, 1), (1, 1), scale))

    x = _codes(2, 32, 6, seed=9)
    program = torch.export.export(Net(), (x,), strict=False)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert torch.ops.micronet_tpu_torch.patch_matrix.default in targets
    assert torch.ops.micronet_tpu_torch.patch_shuffle.default in targets
    for got, want in zip(program.module()(x), Net()(x)):
        _same_bits(got, want)


def test_kernels_are_counted_and_no_gemm_or_conv_to_the_benchmark():
    """The benchmark's GEMM rule and its convolution rule class neither
    kernel; ``engine_patch_kernels_per_fwd`` counts their launches a call
    (None where a call launches none)."""
    from portbench import harness

    is_gemm = harness.load_module("layers", "gemm_roofline_pct.infer").is_gemm
    is_conv = harness.load_module("layers", "qat_nonconv_ms").is_conv
    reader = harness.load_module("layers", "engine_patch_kernels_per_fwd").read
    names = [f"void (anonymous namespace)::patch_matrix_kernel<{o}, {v}>"
             f"((anonymous namespace)::MatrixParams)"
             for o, v in (("signed char", 16), ("signed char", 4), ("signed char", 1),
                          ("float", 1))]
    names += [f"void (anonymous namespace)::patch_shuffle_kernel<{t}>"
              f"((anonymous namespace)::ShuffleParams)" for t in ("true", "false")]
    assert not any(is_gemm(n) or is_conv(n) for n in names)
    assert is_gemm("sm90_xmma_gemm_s8s8_s32") and is_conv("sm90_xmma_fprop_conv")
    kernels = [[names[i % len(names)], 1e-4] for i in range(9)]
    kernels += [["sm90_xmma_gemm_s8s8_s32", 1e-3]] * 9
    run = types.SimpleNamespace(window={"kind": "infer"},
                                stretch={"kernels": kernels * 5, "steps": 5})
    assert reader(run) == 9
    run.stretch = {"kernels": kernels[9:] * 5, "steps": 5}
    assert reader(run) is None


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches() -> int:
    return PG.patch_matrix.launches + PG.patch_shuffle.launches


def _launched(fn, *args, **kw):
    before = _launches()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,k,s,p,d,f32", NET_PATCHES + EXTRA_PATCHES)
def test_patch_kernel_equals_twin_byte_for_byte(card, c, h, k, s, p, d, f32):
    """At batch 2 and at the cells' batch (1,024 for NIN-GC's shapes and
    MobileNetV2's stem, 512 for ResNet-18's; the extra shapes at 64): the
    kernel's output equals the twin's on the card and on the CPU, int8
    codes byte for byte, the f32 variant bit for bit; one launch a
    call."""
    geo = _geometry(k, s, p, d)
    big = 1024 if (c, h, k) in ((3, 32, 5), (256, 16, 3), (512, 8, 3), (3, 32, 3)) else 512
    big = big if (c, h, k, s, p, d, f32) in NET_PATCHES else 64
    for n in (2, big):
        x = _codes(n, c, h, seed=n + c, dev=card)
        scale = _scale(card) if f32 else None
        got = _launched(PG.patch_matrix, x, *geo, scale=scale)
        assert got.is_contiguous()
        _same_bits(got, PG.patch_matrix_ref(x, *geo, scale=scale))
        if n == 2:
            _same_bits(got, PG.patch_matrix_ref(x.cpu(), *geo,
                                                scale=None if scale is None else scale.cpu()))
        del x, got


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,g", NET_SHUFFLES + EXTRA_SHUFFLES)
def test_shuffle_kernel_equals_twin_byte_for_byte(card, c, h, g):
    """At batch 2 and 1,024: the kernel equals the twin byte for byte as an
    NCHW view of NHWC memory; one launch a call."""
    for n in (2, 1024):
        x = _codes(n, c, h, seed=n + g, dev=card)
        got = _launched(PG.patch_shuffle, x, g)
        assert got.permute(0, 2, 3, 1).is_contiguous()
        assert torch.equal(got, PG.patch_shuffle_ref(x, g))
        del x, got


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4])
def test_kernels_at_unaligned_offsets(card, offset):
    """Codes starting 1 or 4 bytes into their storage take the 1- or 4-byte
    chunks (the shuffle its per-byte kernel) and still equal the twins; so
    do codes in NCHW memory (one NHWC copy first)."""
    n, h, c = 2, 9, 64
    flat = torch.randint(-128, 128, (n * h * h * c + offset,), dtype=torch.int8, device=card)
    x = flat[offset:].reshape(n, h, h, c).permute(0, 3, 1, 2)
    assert PG._vec(c, x) == offset
    for xi in (x, x.contiguous()):
        for geo in (_geometry(3, 1, 1, 1), _geometry(3, 2, 1, 1), _geometry(1, 2, 0, 1)):
            _same_bits(_launched(PG.patch_matrix, xi, *geo), PG.patch_matrix_ref(xi, *geo))
        assert torch.equal(_launched(PG.patch_shuffle, xi, 4), PG.patch_shuffle_ref(xi, 4))
    x3 = flat[offset:offset + n * h * h * 3].reshape(n, h, h, 3).permute(0, 3, 1, 2)
    scale = _scale(card)
    _same_bits(_launched(PG.patch_matrix, x3, *_geometry(3, 1, 1, 1), scale=scale),
               PG.patch_matrix_ref(x3, *_geometry(3, 1, 1, 1), scale=scale))


@pytest.mark.cuda
def test_captured_kernels_replay_equal_the_twins(card):
    """Both kernels captured in one CUDA graph: the capture counts a launch
    each, a replay none, and each replay on new codes equals the twins."""
    static = _codes(64, 256, 16, seed=1, dev=card)
    geo = _geometry(3, 1, 1, 1)

    def step(x):
        s = PG.patch_shuffle(x, 2)
        return s, PG.patch_matrix(s, *geo)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches()
    with torch.cuda.graph(graph):
        shuffled, cols = step(static)
    assert _launches() == before + 2
    for seed in (2, 3):
        static.copy_(_codes(64, 256, 16, seed=seed, dev=card))
        graph.replay()
        torch.cuda.synchronize()
        want = PG.patch_shuffle_ref(static, 2)
        assert torch.equal(shuffled, want)
        _same_bits(cols, PG.patch_matrix_ref(want, *geo))
    assert _launches() == before + 2


# the three engine cells at full width: (net factory, bits, patch kernels an eager forward)
_NETS = {"nin_gc_w4a4": ("micronet_tpu_torch.models.nin_gc:Net", 4, 9),
         "resnet18_w8a8": ("micronet_tpu_torch.models.resnet:resnet18", 8, 20),
         "mobilenetv2_w8a8": ("micronet_tpu_torch.models.mobilenet_v2:mobilenet_v2", 8, 1)}


def _frozen(path: str, bits: int, batch: int, seed: int, dev):
    """The net frozen to the integer engine on ``dev`` from a seed (4
    calibration batches of 64 Gaussian images on the exact f32 path, BN
    folded), and an input batch."""
    import importlib

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    mod, fn = path.split(":")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = QuantConfig(a_bits=bits, w_bits=bits, bn_fuse=True, act_codes="off", bn_stats="off")
    net = getattr(importlib.import_module(mod), fn)(device=dev, generator=gen)
    q = train_mode(prepare(net, cfg, device=dev))
    with torch.no_grad():
        for _ in range(4):
            q(torch.randn((64, 32, 32, 3), device=dev, generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=dev))
    x = torch.randn((batch, 32, 32, 3), device=dev, generator=gen)
    return eval_mode(freeze_int(fused, example_input=x[:1], device=dev)), x


def _parent_im2col(self, x, scale=None):
    """The parent's ``_im2col``: the twin (PyTorch's pad, unfold, permute
    and reshape), over ``x.to(float32) * scale`` for the first layer."""
    n, c, h, w = x.shape
    kernel = self.w_shape[2:]
    geo = self._gemm_geometry()
    ho, wo = PG.out_hw(h, w, kernel, *geo)
    return PG.patch_matrix_ref(x, kernel, *geo, scale), (n, ho, wo)


@pytest.mark.cuda
@pytest.mark.parametrize("net", list(_NETS))
def test_engine_equals_the_parent_route_and_launches_per_forward(card, net, monkeypatch):
    """The cell's engine at full width (256 images): 9, 20 or 1 patch
    kernels an eager forward (NIN-GC: its stem, two 3 x 3 convs, six
    shuffles; ResNet-18: its stem, 16 3 x 3 convs, 3 strided shortcuts;
    MobileNetV2: its stem), every one on NHWC-backed codes (no NHWC copy);
    the logits equal the parent's route (the twins in the kernels' place)
    bit for bit."""
    path, bits, want = _NETS[net]
    eng, x = _frozen(path, bits, 256, 30 + len(net), card)
    backed = []
    nhwc = PG._nhwc_codes

    def recorded(t):
        backed.append(t.permute(0, 2, 3, 1).is_contiguous())
        return nhwc(t)

    with torch.no_grad(), monkeypatch.context() as mp:
        mp.setattr(PG, "_nhwc_codes", recorded)
        before = _launches()
        logits = eng(x)
        torch.cuda.synchronize()
        assert _launches() - before == want
    assert backed == [True] * want
    with torch.no_grad(), monkeypatch.context() as mp:
        mp.setattr(E._IntConvRoutes, "_im2col", _parent_im2col)
        mp.setattr(F, "channel_shuffle", PG.patch_shuffle_ref)
        before = _launches()
        parent = eng(x)
        torch.cuda.synchronize()
        assert _launches() == before
    _same_bits(logits, parent)
