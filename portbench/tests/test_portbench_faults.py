"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, at a tiny size on the CPU, with the cells'
own limits (the look for a card is skipped; the rest of the run is the
benchmark's own)."""

import pytest
import torch

from micronet_tpu_torch.infer.deploy import CompiledEngine
from micronet_tpu_torch.train.loop import Trainer
from micronet_tpu_torch.train.optim import Adam
from portbench.traffic import train_steps

from ._tiny import drive, tiny_run

ENGINES = ["ningc_w4a4.engine_b1024", "resnet18_w8a8.engine_b512"]
TRAINING = ["ningc_w4a4.qat_b256", "ningc_w4a4.qat_dp4_b1024"]


@pytest.mark.parametrize("cell", ENGINES + TRAINING)
def test_sound_run_is_correct(cell):
    run = drive(tiny_run(cell))
    assert run.correct, run.checks


def _answer_altered(self, x):
    y = CompiledEngine.__wrapped_call__(self, x)
    y[-1] = y[-1].flip(0) + 1.0
    return y


def _half_rows(self, x):
    y = CompiledEngine.__wrapped_call__(self, x)
    y[y.shape[0] // 2:] = 0
    return y


@pytest.mark.parametrize("cell", ENGINES)
@pytest.mark.parametrize("fault", [_answer_altered, _half_rows], ids=["answer", "half_batch"])
def test_engine_fault_is_caught(cell, fault, monkeypatch):
    monkeypatch.setattr(CompiledEngine, "__wrapped_call__", CompiledEngine.__call__,
                        raising=False)
    monkeypatch.setattr(CompiledEngine, "__call__", fault)
    run = drive(tiny_run(cell))
    assert not run.correct, run.checks
    assert run.failed > 0


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    step = Trainer.train_step

    def half(self, x, labels):
        n = x.shape[0] // 2
        return step(self, x[:n], labels[:n])

    monkeypatch.setattr(Trainer, "train_step", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch], ids=["unchanged", "half"])
def test_training_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    run = drive(tiny_run("ningc_w4a4.qat_b256"))
    assert not run.correct, run.checks


def no_exchange_rank(rank, world, rendezvous, run, out_dir):
    """A rank whose trainer averages the loss over the ranks but not the
    gradients."""
    mean_over = Trainer._mean_over

    def loss_only(group, tensors):
        mean_over(group, [t for t in tensors if t.dim() == 0])

    Trainer._mean_over = staticmethod(loss_only)
    train_steps.rank_main(rank, world, rendezvous, run, out_dir)


def test_exchange_left_out_is_caught():
    run = drive(tiny_run("ningc_w4a4.qat_dp4_b1024"), entry=no_exchange_rank)
    assert not run.correct, run.checks


def test_nonfinite_loss_counts_as_failed(monkeypatch):
    step = Trainer.train_step

    def nan_step(self, x, labels):
        loss, acc = step(self, x, labels)
        return loss * torch.nan, acc

    monkeypatch.setattr(Trainer, "train_step", nan_step)
    run = drive(tiny_run("ningc_w4a4.qat_b256"))
    assert run.failed > 0 and not run.correct
