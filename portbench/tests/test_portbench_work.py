"""The work counter against hand-computed layer shapes."""

from portbench import work
from portbench.reference import arch


def test_nin_gc_macs_honour_groups():
    ops = arch.build("nin_gc")
    # (H_out * W_out) * C_out * (C_in / groups) * k * k, layer by layer
    hand = [
        32 * 32 * 256 * 3 * 25,
        32 * 32 * 256 * 128,
        32 * 32 * 256 * 128,
        16 * 16 * 512 * 16 * 9,
        16 * 16 * 512 * 128,
        16 * 16 * 512 * 128,
        8 * 8 * 1024 * 16 * 9,
        8 * 8 * 1024 * 128,
        8 * 8 * 10 * 1024,
    ]
    assert [layer["macs"] for layer in work.layers(ops)] == hand
    assert work.forward_macs(ops) == sum(hand) == 157_679_616
    dense = [32 * 32 * 256 * 75, 32 * 32 * 256 * 256, 32 * 32 * 256 * 256,
             16 * 16 * 512 * 256 * 9, 16 * 16 * 512 * 512, 16 * 16 * 512 * 512,
             8 * 8 * 1024 * 512 * 9, 8 * 8 * 1024 * 1024, 8 * 8 * 10 * 1024]
    assert sum(layer["dense_macs"] for layer in work.layers(ops)) == sum(dense) == 959_840_256


def test_resnet18_macs():
    ops = arch.build("resnet18")
    stem = 32 * 32 * 64 * 27
    stage = {64: 4 * 32 * 32 * 64 * 64 * 9}
    s128 = 16 * 16 * 128 * (64 * 9 + 128 * 9 * 3 + 64)
    s256 = 8 * 8 * 256 * (128 * 9 + 256 * 9 * 3 + 128)
    s512 = 4 * 4 * 512 * (256 * 9 + 512 * 9 * 3 + 256)
    hand = stem + stage[64] + s128 + s256 + s512 + 512 * 10
    assert work.forward_macs(ops) == hand == 555_422_720
    assert len(work.layers(ops)) == 1 + 16 + 3 + 1


def test_training_counts_three_forwards():
    ops = arch.build("nin_gc")
    assert work.train_flops_per_image(ops) == 6 * 157_679_616


def test_gemm_bound_is_positive_and_grows_with_batch():
    ops = arch.build("resnet18")
    assert 0 < work.engine_gemm_bound_s(ops, 256) < work.engine_gemm_bound_s(ops, 512)
