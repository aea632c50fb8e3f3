"""The MobileNetV2 W8A8 cell: its work count and depthwise bound, its files
through the harness, its runner on the CPU at a tiny size, and its three
per-layer readers on made-up stretches."""

import time

import pytest

from portbench import harness, work
from portbench.reference import arch
from portbench.reference.iao import IaoNet
from portbench.reference.archs import mobilenet_v2 as ref_arch
from portbench.traffic import engine_closed_arch

CELL = "mobilenetv2_w8a8.engine_arch_b1024"
NEW = ("engine_dwconv_ms", "engine_dwconv_per_fwd", "dwconv_roofline_pct")


def test_forward_macs():
    ops = arch.build("mobilenet_v2")
    assert work.forward_macs(ops) == 87_976_448
    layers = work.layers(ops)
    assert len(layers) == 53  # 52 convs and the classifier
    dw = [layer for layer in layers if layer["groups"] > 1]
    assert len(dw) == 17 and sum(layer["macs"] for layer in dw) == 5_879_808


def test_depthwise_bound():
    roof = harness.load_module("layers", "dwconv_roofline_pct")
    ops = arch.build("mobilenet_v2")
    assert sum(map(roof.is_depthwise, work.layers(ops))) == 17
    assert round(roof.bound_s(ops, 1024) * 1e3, 3) == 0.453
    # bytes bound it: the operations alone would take 6 us
    ops_only = sum(2 * layer["macs"] * 1024 for layer in work.layers(ops)
                   if roof.is_depthwise(layer)) / work.PEAKS["int8_ops"]
    assert ops_only < 0.02 * roof.bound_s(ops, 1024)


def test_cell_files_load():
    bench = harness.load_bench()
    run = harness.make_run(CELL, 2**31 + 11, 20.0, False, 0.0)
    assert run.config["arch"] == "mobilenet_v2" and run.traffic["runner"] == "engine_closed_arch"
    assert run.traffic["batch"] == 1024 and run.spec["chips"] == 1
    assert engine_closed_arch.net_class(run.config) is ref_arch.Net
    assert engine_closed_arch.net_class({"arch": "resnet18"}) is IaoNet
    cfg = next(c for c in bench["configs"] if c["name"] == "mobilenetv2_w8a8")
    others = [c for c in bench["configs"] if c["name"] != "mobilenetv2_w8a8"]
    assert all(c["source"] != cfg["source"] and sorted(c["reduced"]) != sorted(cfg["reduced"])
               for c in others)
    traced = [n for n, _ in harness.metric_names(bench, CELL, True)]
    assert set(NEW) <= set(traced) and "gemm_roofline_pct.infer" not in traced
    assert {n for n, _ in harness.metric_names(bench, CELL, False)} == {
        "infer_img_per_s", "infer_call_p95_ms", "setup_s"}
    assert set(run.spec["limits"]) <= {"logit_gap", "top1_regret", "logit_mean_gap"}


def test_tiny_run_reads_correct():
    """The runner at a narrow width on the CPU: the engine's logits beside
    the reference ``Net``'s are within the cell's limits, and the result
    line holds its numbers."""
    widths = [16, 8, 12, 16, 24, 32, 40, 48, 64]
    run = harness.make_run(CELL, 2**31 + 5, 0.3, False, time.time(), device="cpu")
    run.config["widths"] = widths
    run.config["model"]["kwargs"] = {"widths": widths}
    run.traffic.update(batch=4, pool=2, calib_batch=8, calib_steps=2, trace_calls=2)
    engine_closed_arch.run(run)
    assert run.correct and run.attempted >= 1 and run.failed == 0
    assert set(harness.result(run, {})["checks"]) == set(run.spec["limits"])


def _run(kernels, labels=None, calls=2):
    class R:
        pass

    r = R()
    r.window = dict(kind="infer", batch=1024, calls=3, seconds=1.0)
    r.stretch = dict(kernels=kernels, steps=calls)
    r.config = {"arch": "mobilenet_v2"}
    r.spans = None if labels is None else dict(labels_s=labels)
    r.trace = True
    return r


@pytest.mark.parametrize("labels,want", [({"int.dwconv": 0.002, "int.gemm": 0.003}, 2.0),
                                         ({"int.gemm": 0.003}, None), (None, None)])
def test_readers(labels, want):
    kernels = [["void (anonymous namespace)::dwconv_int8_kernel<1, true, true>", 1e-4]] * 34 \
        + [["gemm", 1e-4]] * 4
    r = _run(kernels, labels)
    read = {name: harness.load_module("layers", name).read for name in NEW}
    assert read["engine_dwconv_per_fwd"](r) == 17
    assert read["engine_dwconv_ms"](r) == want
    pct = read["dwconv_roofline_pct"](r)
    if want is None:
        assert pct is None
    else:
        assert pct == pytest.approx(100 * 0.4529414017910447 / want)
    assert read["engine_dwconv_per_fwd"](_run([["gemm", 1e-4]])) is None
