"""The plain reference against the program at a tiny size on the CPU,
where the program runs its exact path (a test may import both)."""

import copy

import pytest
import torch

from micronet_tpu_torch.infer import fuse_bn_iao
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.nn.functional import channel_shuffle
from portbench import compare, program, weights, work
from portbench.reference import arch
from portbench.reference.iao import IaoNet, shuffle_channels
from portbench.reference.train import augment, run_steps
from portbench.traffic import engine_closed, train_steps

from ._tiny import TINY_NIN, tiny_run


@pytest.mark.parametrize("cell", ["ningc_w4a4.engine_b1024", "resnet18_w8a8.engine_b512"])
def test_weight_keys_are_the_programs(cell):
    run = tiny_run(cell)
    ops = work.arch_ops(run.config)
    w = weights.make_weights(ops, weights.generator(1, "cpu"), "cpu")
    model = program.float_model(run.config, w, "cpu")
    assert set(model.state_dict()) == set(w)


def test_shuffle_is_the_programs():
    x = torch.arange(2 * 64 * 3 * 3, dtype=torch.float32).reshape(2, 64, 3, 3)
    for g in (2, 4, 16, 32):
        assert torch.equal(shuffle_channels(x, g), channel_shuffle(x, g))


@pytest.mark.parametrize("cell", ["ningc_w4a4.engine_b1024", "resnet18_w8a8.engine_b512"])
def test_calibrated_fake_quant_model_is_the_programs(cell):
    run = tiny_run(cell)
    ops = work.arch_ops(run.config)
    gen = weights.generator(7, "cpu")
    w = weights.make_weights(ops, gen, "cpu")
    calib = weights.gaussian_images(gen, "cpu", 2, 4)
    x = weights.gaussian_images(gen, "cpu", 4)
    cfg = program.quant_config(run.config, run.config["calibration_lowerings"])
    q = train_mode(prepare(program.float_model(run.config, w, "cpu"), cfg, device="cpu"))
    with torch.no_grad():
        for c in calib:
            q(c)
        fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device="cpu"))
        got = fused(x)
    ref = engine_closed.reference_logits(ops, w, calib, x[None], run.config["quant"], "exact")[0]
    assert torch.allclose(got, ref, rtol=0, atol=1e-5)


def test_control_bits_move_the_logits():
    run = tiny_run("ningc_w4a4.engine_b1024")
    ops = work.arch_ops(run.config)
    gen = weights.generator(8, "cpu")
    w = weights.make_weights(ops, gen, "cpu")
    calib = weights.gaussian_images(gen, "cpu", 2, 4)
    pool = weights.gaussian_images(gen, "cpu", 1, 4)
    ref = engine_closed.reference_logits(ops, w, calib, pool, {"a_bits": 4, "w_bits": 4}, "exact")
    low = engine_closed.reference_logits(ops, w, calib, pool, {"a_bits": 3, "w_bits": 3}, "exact")
    numbers, _ = compare.engine_numbers([(0, low[0])], ref)
    assert numbers["logit_gap"] > 0.05
    assert 0 < numbers["logit_mean_gap"] <= numbers["logit_gap"]
    epi = engine_closed.reference_logits(ops, w, calib, pool, {"a_bits": 4, "w_bits": 4}, "exact",
                                         torch.bfloat16)
    assert not torch.equal(epi[0], ref[0])
    assert compare.engine_numbers([(0, ref[0])], ref)[0]["logit_mean_gap"] == 0


def test_augmentation_is_the_programs():
    from micronet_tpu_torch.train import data

    gen = weights.generator(9, "cpu")
    images, _ = weights.uint8_set(gen, "cpu", 6)
    offsets, flips = data.draw_augment(gen, 6)
    assert torch.equal(augment(images, offsets, flips), data.apply_augment(images, offsets, flips))


def test_feed_draws_every_crop_and_both_flips():
    gen = weights.generator(13, "cpu")
    images, labels = weights.uint8_set(gen, "cpu", 512)
    _, _, (_, _, offsets, flips) = next(train_steps._feed(images, labels, 512, gen,
                                                          weights.generator(14, "cpu"), "cpu"))
    assert set(offsets.flatten().tolist()) == set(range(9))
    assert 0.4 < flips.float().mean() < 0.6


@pytest.mark.parametrize("stats", ["exact", "acc"])
def test_training_steps_are_the_programs(stats):
    """Two steps of the program's trainer against the reference's, with the
    program's lowering pinned to the statistics the reference computes."""
    run = tiny_run("ningc_w4a4.qat_b256")
    run.config["train_lowerings"] = {"act_codes": "off",
                                     "bn_stats": "off" if stats == "exact" else "acc"}
    ops = work.arch_ops(run.config)
    gen = weights.generator(11, "cpu")
    w = weights.make_weights(ops, gen, "cpu")
    images, labels = weights.uint8_set(gen, "cpu", 8)
    feed = train_steps._feed(images, labels, 4, gen, weights.generator(12, "cpu"), "cpu")
    trainer = program.trainer(run.config, w, dict(run.traffic, batch=4), None, "cpu")
    conv_to_bn = {c["conv"]: c["bn"] for c in arch.conv_layers(ops)}
    named = [(program.program_leaf(n, conv_to_bn), p) for n, p in
             trainer.model.named_parameters()]
    start = {k: p.detach().clone() for k, p in named}
    records, losses, grads = [], [], None
    for i in range(2):
        x, y, rec = next(feed)
        records.append(rec)
        losses.append(float(trainer.train_step(x, y)[0]))
        if i == 0:
            grads = {k: trainer.optimizer.state[p]["mu"] / 0.1 for k, p in named}
    ref = run_steps(IaoNet(ops, copy.deepcopy(w), 4, 4, stats=stats), records, 1e-3, 1e-7)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    # leaves whose gradient is nought to rounding move by round-off alone
    moved = compare.kept_leaves(compare.norms(ref["grad"]))
    assert len(moved) > len(named) // 2
    for k, p in named:
        assert torch.allclose(grads[k], ref["grad"][k], rtol=1e-3, atol=1e-6), k
        if k in moved:
            assert torch.allclose(p.detach() - start[k], ref["delta"][k], rtol=1e-3,
                                  atol=1e-7), k
