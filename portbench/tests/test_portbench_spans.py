"""The readers of the program's spans (``spans.py`` and the layers named
after its metrics): kernels go to spans by their launch's correlation on
any thread; the eager forward's labels go onto the replays only where the
names match; every reader finds nothing in a cell of the other kind or in
a program without spans; a tiny traced run on the CPU reads the host's
times."""

import subprocess

import pytest

from portbench import harness, spans

from ._tiny import drive, tiny_run

ENGINE_READERS = ["engine_epilogue_ms", "engine_im2col_ms", "engine_quantize_ms",
                  "host_ms.infer", "host_copy_ms.infer", "host_replay_ms.infer"]
TRAIN_READERS = ["train_fwd_ms", "train_bwd_ms", "train_optim_ms", "host_ms.train"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _step_events():
    """One step: the main thread in ``train.step`` (forward, then backward,
    then the optimizer); the backward's launches on autograd's thread; the
    kernels run later on the card than their launches."""
    return [
        _x("user_annotation", "train.step", 0, 100),
        _x("user_annotation", "train.forward", 10, 30),
        _x("user_annotation", "fn.shuffle", 20, 5),
        _x("user_annotation", "train.backward", 40, 40),
        _x("user_annotation", "train.optimizer", 85, 10),
        _x("user_annotation", "portbench.stretch", 0, 500),
        _x("cpu_op", "aten::add", 12, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 1, tid=2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 90, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=5),
        _x("kernel", "fwd", 200, 10, tid=7, correlation=1),
        _x("kernel", "shuffle", 210, 20, tid=7, correlation=2),
        _x("kernel", "bwd", 230, 40, tid=7, correlation=3),
        _x("kernel", "adam", 270, 5, tid=7, correlation=4),
        _x("kernel", "after", 280, 1, tid=7, correlation=5),
        _x("kernel", "unlaunched", 290, 2, tid=7, correlation=99),
    ]


def test_kernels_go_to_spans_by_their_launch_on_any_thread():
    got = spans.kernels_by_span(_step_events())
    assert [(k.name, k.spans) for k in got] == [
        ("fwd", ["train.forward", "train.step"]),
        ("shuffle", ["fn.shuffle", "train.forward", "train.step"]),
        ("bwd", ["train.backward", "train.step"]),
        ("adam", ["train.optimizer", "train.step"]),
        ("after", []),
        ("unlaunched", [])]
    sec = {k: round(v * 1e6, 6) for k, v in spans.span_seconds(got).items()}
    assert sec == {"train.step": 75, "train.forward": 30, "fn.shuffle": 20,
                   "train.backward": 40, "train.optimizer": 5, "": 3}


def test_kernels_by_span_keeps_copies_where_asked():
    events = _step_events() + [
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 1, correlation=6),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 205, 2, tid=7, correlation=6)]
    assert "Memcpy DtoD (Device -> Device)" not in [k.name for k in spans.kernels_by_span(events)]
    got = [k for k in spans.kernels_by_span(events, copies=True) if k.copy]
    assert [(k.name, k.spans) for k in got] == [
        ("Memcpy DtoD (Device -> Device)", ["train.forward", "train.step"])]


@pytest.mark.parametrize("held,label", [
    (["int.epilogue", "engine.replay", "engine.call"], "int.epilogue"),
    (["fn.shuffle", "engine.replay"], "int.im2col"),
    (["int.pool", "int.epilogue"], "int.pool"),
    (["engine.replay", "engine.call"], ""),
    ([], "")])
def test_a_kernel_takes_the_role_of_its_innermost_engine_span(held, label):
    assert spans.role(held) == label


# an eager forward: (name, its role, a copy); its second copy
# runs in a replay as the graph's kernel memcpy32_post, its first as a copy
EAGER = [("quant", "int.quantize", False), ("Memcpy DtoD", "int.im2col", True),
         ("mm", "int.gemm", False), ("Memcpy DtoD", "int.gemm", True),
         ("req", "int.epilogue", False), ("relu", "", False)]


def test_replay_labels_join_by_position_call_by_call():
    replays = [["quant", 1e-3], ["mm", 2e-3], ["memcpy32_post", 1e-4], ["req", 3e-3],
               ["relu", 4e-4],
               ["quant", 3e-3], ["mm", 2e-3], ["memcpy32_post", 3e-4], ["req", 3e-3],
               ["relu", 4e-4]]
    got = spans.replay_labels(EAGER, replays, 2)
    assert got == pytest.approx({"int.quantize": 2e-3, "int.gemm": 2.2e-3, "int.epilogue": 3e-3,
                                 "": 4e-4})


@pytest.mark.parametrize("replays,calls", [
    ([["quant", 1.0], ["mm", 1.0], ["req", 1.0], ["relu", 1.0],
      ["mm", 1.0], ["quant", 1.0], ["req", 1.0], ["relu", 1.0]], 2),
    ([["quant", 1.0], ["mm", 1.0], ["req", 1.0], ["relu", 1.0]] * 2, 3),
    ([["quant", 1.0], ["mm", 1.0], ["req", 1.0], ["relu", 1.0], ["x", 1.0]], 1),
    ([["quant", 1.0], ["mm", 1.0], ["req", 1.0]], 1),
    ([["quant", 1.0], ["memcpy32_post", 1.0], ["mm", 1.0], ["memcpy32_post", 1.0],
      ["memcpy32_post", 1.0], ["req", 1.0], ["relu", 1.0]], 1),
    ([["memcpy32_post", 1.0], ["quant", 1.0], ["mm", 1.0], ["req", 1.0], ["relu", 1.0]], 1),
    ([], 0)], ids=["name_mismatch", "count_mismatch", "extra_kernel", "kernel_left_over",
                   "copy_too_many", "copy_out_of_place", "no_calls"])
def test_replay_labels_find_nothing_unless_the_kernels_match(replays, calls):
    assert spans.replay_labels(EAGER, replays, calls) is None


def test_host_ms_sums_by_root():
    from micronet_tpu_torch.utils.profiling import SpanRecord

    recs = [SpanRecord("train.augment", 0, 1_000_000, None, 0),
            SpanRecord("train.step", 2_000_000, 7_000_000, None, 1),
            SpanRecord("train.forward", 2_500_000, 3_000_000, 1, 1),
            SpanRecord("train.augment", 8_000_000, 9_500_000, None, 2),
            SpanRecord("train.step", 10_000_000, 14_000_000, None, 3),
            SpanRecord("train.step", 20_000_000, None, None, 4)]
    assert spans.host_ms(recs, ("train.step",)) == [5.0, 4.0]
    assert spans.host_ms(recs, ("train.augment",)) == [1.0, 1.5]


def _fake(kind, ranks=1):
    run = harness.make_run("ningc_w4a4.qat_b256" if kind == "train" else
                           "ningc_w4a4.engine_b1024", 1, 1.0, True, 0.0, device="cpu")
    run.window = dict(kind=kind, ranks=ranks)
    run.stretch = dict(kernels=[["k", 1e-3]], steps=1, busy_s=1e-3, window_s=2e-3)
    return run


@pytest.mark.parametrize("metric,kind", [(m, "train") for m in ENGINE_READERS]
                         + [(m, "infer") for m in TRAIN_READERS]
                         + [(m, "train_dp") for m in TRAIN_READERS])
def test_each_reader_finds_nothing_in_a_cell_of_another_kind(metric, kind, monkeypatch):
    def no_measurement(run):
        raise AssertionError("measured in a cell of another kind")

    monkeypatch.setattr(spans, "measure", no_measurement)
    run = _fake("train", ranks=4) if kind == "train_dp" else _fake(kind)
    assert harness.load_module("layers", metric).read(run) is None


@pytest.mark.parametrize("metric", ENGINE_READERS + TRAIN_READERS)
def test_each_reader_finds_nothing_in_a_program_without_spans(metric, monkeypatch):
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    run = _fake("infer" if metric in ENGINE_READERS else "train")
    assert harness.load_module("layers", metric).read(run) is None
    assert run.spans is None


def test_a_failed_measuring_process_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 1, stdout=""))
    run = _fake("infer")
    assert all(harness.load_module("layers", m).read(run) is None for m in ENGINE_READERS)
    assert run.spans is None


@pytest.mark.parametrize("cell,host,device", [
    ("resnet18_w8a8.engine_b512", ENGINE_READERS[3:], ENGINE_READERS[:3]),
    ("ningc_w4a4.qat_b256", TRAIN_READERS[3:], TRAIN_READERS[:3])])
def test_a_tiny_traced_run_reads_the_hosts_times(cell, host, device, monkeypatch):
    """On the CPU the traced stretch holds no kernel, so the device readers
    find nothing; the host's times come from spans the program recorded in
    the measuring process, one set per call or step of the host-only
    stretch, whose count is its own and not the traffic's."""
    monkeypatch.setattr(spans, "HOST_CALLS", 3)
    monkeypatch.setattr(spans, "HOST_STEPS", 3)
    run = drive(tiny_run(cell, trace=True))
    for m in host:
        got = harness.load_module("layers", m).read(run)
        assert got is not None and got > 0
    assert all(harness.load_module("layers", m).read(run) is None for m in device)
    assert run.traffic["trace_calls" if run.window["kind"] == "infer" else "trace_steps"] == 2
    assert all(len(v) == 3 for v in run.spans["host_ms"].values())
    assert run.spans["dropped"] == 0
