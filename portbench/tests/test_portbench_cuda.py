"""Card tests: each cell's control, at the cell's own size on three
seeds, fails the cell's limits, and a short run of each one-card cell is
correct. Run on a machine with a card (python -m pytest portbench/tests
-m cuda -n 0); they skip elsewhere."""

import time

import pytest
import torch

from portbench import compare, controls, harness

pytestmark = pytest.mark.cuda

ONE_CARD = ["ningc_w4a4.engine_b1024", "resnet18_w8a8.engine_b512", "ningc_w4a4.qat_b256"]
ALL = ONE_CARD + ["ningc_w4a4.qat_dp4_b1024"]
# the planted faults each cell's limits fail besides the control (a bf16
# epilogue moves few 4-bit codes, so NIN-GC's engine is not held to it)
MUST_FAIL = {"ningc_w4a4.engine_b1024": ("answer_altered",),
             "resnet18_w8a8.engine_b512": ("one_bit_narrower", "bf16_epilogue", "answer_altered"),
             "ningc_w4a4.qat_b256": ("half_batch",),
             "ningc_w4a4.qat_dp4_b1024": ("half_batch", "no_exchange")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fails(numbers, limits):
    return any(not (numbers[k] <= lim) for k, lim in limits.items())


@pytest.mark.parametrize("cell", ALL)
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
def test_control_fails_the_limits(card, cell, seed):
    run = harness.make_run(cell, seed, 1.0, False, time.time())
    out = (controls.engine_control(run) if run.traffic["runner"] == "engine_closed"
           else controls.train_control(run))
    limits = run.spec["limits"]
    assert _fails(out["control"], limits), out["control"]
    for fault in MUST_FAIL[cell]:
        if fault in out:
            assert _fails(out[fault], limits), (fault, out[fault])


@pytest.mark.parametrize("cell", ONE_CARD)
def test_short_run_is_correct(card, cell):
    run = harness.make_run(cell, 7100, 2.0, False, time.time())
    harness.traffic_runner(run.traffic["runner"]).run(run)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


def test_a_state_left_unchanged_reads_one():
    readings = {"losses": [2.3], "grad": {"a": 1.0, "b": 2.0}, "delta": {"a": 0.0, "b": 0.0}}
    ref = {"losses": [2.3], "grad": {"a": 1.0, "b": 2.0}, "delta": {"a": 0.1, "b": 0.2}}
    assert compare.train_numbers(readings, ref)["step_gap"] == 1.0
