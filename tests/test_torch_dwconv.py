"""The integer engine's depthwise route (``ops/dwconv.py``) against the
block-diagonal one (im2col, an int32 GEMM over the block-diagonal weight,
then the requant epilogue), which every other grouped conv runs.

CPU cases: the operator runs its twin on CPU tensors, and equals the
block-diagonal route run on CPU tensors bit for bit (codes and f32, with
and without a bias, strides 1 and 2, padding 0 and 1); the route records
the span ``int.dwconv``; ``torch.export`` keeps the operator. Card cases
(marked ``cuda``; they skip without a card) hold the kernel to the
block-diagonal route on the card and to the CPU twin bit for bit at every
depthwise layer shape of MobileNetV2 at 32 x 32 (C from 32 to 960, H from
32 to 4, strides 1 and 2) at batch 2 and 1,024, and at rows that are not
16-byte aligned. The file imports torch only (no JAX), so it also runs
without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_dwconv.py
"""

import copy

import pytest
import torch

from micronet_tpu_torch.infer import engine as E
from micronet_tpu_torch.ops import dwconv as D
from micronet_tpu_torch.utils import profiling

# (C, H, stride) of MobileNetV2's 17 depthwise layers at 32 x 32 (portbench's
# reference/archs/mobilenet_v2.py), each shape once
MOBILENET_DW = [(32, 32, 1), (96, 32, 1), (144, 32, 1), (144, 32, 2), (192, 16, 1),
                (192, 16, 2), (384, 8, 1), (576, 8, 1), (576, 8, 2), (960, 4, 1)]


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


def _layer(c: int, stride: int, padding: int, chained: bool, bias: bool, seed: int,
           dev="cpu") -> E.IntConv2d:
    """A frozen symmetric W8A8 depthwise conv with random codes and scales
    of a calibrated layer's size."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randint(-127, 128, (c, 1, 3, 3), dtype=torch.int8, generator=gen)
    w_scale = torch.rand((c,), generator=gen) * 2e-3 + 1e-4
    b = torch.randn((c,), generator=gen) * 0.5 if bias else None
    conv = E.IntConv2d(w, w_scale, torch.tensor(0.021), b, (stride, stride), (padding, padding),
                       (1, 1), c, -128.0, 127.0)
    conv.chained = chained
    conv.out_scale.fill_(0.017 + 0.01 * torch.rand((), generator=gen).item())
    return conv.to(dev)


def _codes(n: int, c: int, h: int, seed: int, dev="cpu") -> torch.Tensor:
    """int8 codes (N, C, H, H) as the engine hands them on: an NCHW view of
    NHWC rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-128, 128, (n, h, h, c), dtype=torch.int8, device=dev, generator=gen)
    return x.permute(0, 3, 1, 2)


def _block_diagonal(conv: E.IntConv2d, x: torch.Tensor) -> torch.Tensor:
    return conv._epilogue(conv._int_acc_im2col(x), conv.w_scale)


@pytest.mark.parametrize("c,h,stride,padding", [(8, 6, 1, 1), (12, 7, 2, 1), (10, 5, 1, 0),
                                                (16, 9, 2, 0)])
@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_twin_equals_the_block_diagonal_route(c, h, stride, padding, chained, bias):
    """On CPU tensors the route (the operator's twin) gives the block-diagonal
    route's bits (its int32 GEMM run on CPU tensors), in codes and in f32,
    as the same NCHW view of (M, C) rows."""
    conv = _layer(c, stride, padding, chained, bias, seed=c * 10 + h)
    assert conv.depthwise
    x = _codes(3, c, h, seed=h)
    got, want = conv.dwconv(x), _block_diagonal(conv, x)
    _same_bits(got, want)
    assert got.stride() == want.stride()
    _same_bits(conv(x), want)


def test_route_records_its_span():
    conv = _layer(8, 1, 1, True, True, seed=1)
    profiling.take_spans()
    with profiling.spans_on(), torch.no_grad():
        conv(_codes(2, 8, 5, seed=2))
    records, _ = profiling.take_spans()
    assert [r.name for r in records] == ["int.dwconv"]


@pytest.mark.parametrize("chained", [True, False])
def test_export_keeps_the_operator(chained):
    """Under ``torch.export`` the fake implementation gives the output's
    shape and dtype; the program calls the operator and equals the eager
    conv."""
    conv = _layer(12, 2, 1, chained, True, seed=4)
    x = _codes(2, 12, 9, seed=5)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = conv

        def forward(self, a):
            return self.conv(a)

    program = torch.export.export(Net(), (x,), strict=False)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert torch.ops.micronet_tpu_torch.dwconv_int8.default in targets
    _same_bits(program.module()(x), conv(x))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(conv: E.IntConv2d, x: torch.Tensor, n_cpu: int = 4) -> None:
    """The kernel (one launch) against the block-diagonal route on the card
    (the GEMM and the requant_epilogue kernel) and, on the first
    ``n_cpu`` images, against the CPU twin."""
    before = D.dwconv_int8.launches
    with torch.no_grad():
        got = conv.dwconv(x)
        torch.cuda.synchronize()
        assert D.dwconv_int8.launches == before + 1
        want = _block_diagonal(conv, x)
    _same_bits(got, want)
    assert got.stride() == want.stride()
    with torch.no_grad():
        _same_bits(got[:n_cpu], copy.deepcopy(conv).cpu().dwconv(x[:n_cpu].cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,stride", MOBILENET_DW)
@pytest.mark.parametrize("batch", [2, 1024])
@pytest.mark.parametrize("chained", [True, False])
def test_kernel_equals_the_block_diagonal_route(card, c, h, stride, batch, chained):
    conv = _layer(c, stride, 1, chained, True, seed=c + h + stride, dev=card)
    _card_case(conv, _codes(batch, c, h, seed=batch + c, dev=card))


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,stride,padding,offset", [
    (36, 8, 1, 1, 0),   # rows of 36 bytes: 4-byte, not 16-byte aligned (the vector kernel)
    (36, 9, 2, 1, 4),   # codes 4 bytes into their storage
    (36, 8, 1, 1, 1),   # codes 1 byte in: the scalar kernel
    (10, 7, 1, 1, 0),   # C % 4 != 0: the scalar kernel
    (20, 9, 2, 0, 0),   # no padding
])
@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_kernel_at_unaligned_rows(card, c, h, stride, padding, offset, chained, bias):
    conv = _layer(c, stride, padding, chained, bias, seed=c * h + offset, dev=card)
    n = 5
    flat = torch.empty(n * h * h * c + offset, dtype=torch.int8, device=card)
    x = flat[offset:].view(n, h, h, c)
    x.copy_(_codes(n, c, h, seed=offset, dev=card).permute(0, 2, 3, 1))
    _card_case(conv, x.permute(0, 3, 1, 2))


@pytest.mark.cuda
def test_kernel_takes_plain_nchw_codes_and_strides_it_cannot_vectorize(card):
    """Codes in plain NCHW memory (the wrapper makes them NHWC first) and
    unequal strides (the scalar kernel) give the block-diagonal bits."""
    conv = _layer(24, 1, 1, True, True, seed=9, dev=card)
    _card_case(conv, _codes(3, 24, 8, seed=3, dev=card).contiguous())
    conv = _layer(24, 1, 1, True, True, seed=9, dev=card)
    conv.stride = (1, 2)
    _card_case(conv, _codes(3, 24, 8, seed=3, dev=card))


@pytest.mark.cuda
def test_captured_kernel_replays_equal_eager(card):
    conv = _layer(96, 1, 1, True, True, seed=2, dev=card)
    static = _codes(64, 96, 16, seed=1, dev=card).contiguous(memory_format=torch.channels_last)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        conv.dwconv(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = D.dwconv_int8.launches
    with torch.cuda.graph(graph), torch.no_grad():
        out = conv.dwconv(static)
    assert D.dwconv_int8.launches == before + 1
    for seed in (5, 6):
        static.copy_(_codes(64, 96, 16, seed=seed, dev=card))
        graph.replay()
        torch.cuda.synchronize()
        with torch.no_grad():
            _same_bits(out, _block_diagonal(conv, static))
    assert D.dwconv_int8.launches == before + 1
