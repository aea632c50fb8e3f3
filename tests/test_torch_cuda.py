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
