"""The port's spans (``utils/profiling.py``: ``span``, ``spans_on``,
``take_spans``): off they cost a flag read and nothing else; on they nest,
land in a ``torch.profiler`` trace as ``user_annotation`` events on the
recorder's clock, and leave every result bit for bit as it was, in the
engine's call, its integer modules and a training step."""

import json
import os
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu_torch.infer import build_engine, deserialize_engine, freeze_int, fuse_bn_iao
from micronet_tpu_torch.infer import serialize_engine
from micronet_tpu_torch.infer.engine import _IntConvRoutes
from micronet_tpu_torch.models import nin_gc
from micronet_tpu_torch.models.resnet import BasicBlock, ResNet
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import data as data_lib
from micronet_tpu_torch.train.data import Cifar10
from micronet_tpu_torch.train.loop import TrainConfig, Trainer
from micronet_tpu_torch.utils import profiling
from micronet_tpu_torch.utils.profiling import span, spans_on, take_spans

NETS = {
    "nin_gc_w4a4": (lambda g: nin_gc.Net(cfg=[64] * 8, device="cpu", generator=g),
                    dict(a_bits=4, w_bits=4, bn_fuse=True), 32),
    "resnet_w8a8": (lambda g: ResNet(BasicBlock, [1, 1, 1, 1], device="cpu", generator=g),
                    dict(a_bits=8, w_bits=8, bn_fuse=True), 8),
}


@pytest.fixture(autouse=True)
def no_spans_left():
    take_spans()
    yield
    take_spans()


def _images(seed: int, n: int, size: int) -> torch.Tensor:
    return torch.randn(n, size, size, 3, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def engines():
    """Each net calibrated on two batches, BN folded, frozen to the
    integer engine on the CPU."""
    out = {}
    for name, (make, quant, size) in NETS.items():
        cfg = QuantConfig(**quant)
        q = train_mode(prepare(make(torch.Generator().manual_seed(0)), cfg, inplace=True,
                               device="cpu"))
        with torch.no_grad():
            for i in range(2):
                q(_images(i, 4, size))
        fused = fuse_bn_iao(eval_mode(q), cfg, inplace=True, device="cpu")
        out[name] = (eval_mode(freeze_int(eval_mode(fused), inplace=True,
                                          example_input=_images(9, 1, size), device="cpu")),
                     size)
    return out


def test_off_span_is_one_shared_noop_and_records_nothing():
    assert not profiling._on
    assert span("a") is span("b") is profiling._NOOP
    with span("a"), span("b"):
        pass
    assert take_spans() == ([], 0)


def test_off_span_allocates_nothing_and_calls_no_torch():
    """The off path, profiled call by call: ``span`` and the no-op's
    ``__enter__``/``__exit__``, no other Python function and no C function;
    and over many calls no allocation in the recorder's file."""
    calls = []

    def hook(frame, event, arg):
        if event == "call":
            calls.append((os.path.basename(frame.f_code.co_filename), frame.f_code.co_name))
        elif event == "c_call":
            calls.append(("C", arg.__name__))

    sys.setprofile(hook)
    try:
        with span("engine.call"):
            pass
    finally:
        sys.setprofile(None)
    assert set(calls) - {("C", "setprofile")} <= {
        ("profiling.py", "span"), ("contextlib.py", "__enter__"), ("contextlib.py", "__exit__")}
    assert ("profiling.py", "span") in calls

    tracemalloc.start()
    try:
        for _ in range(10_000):
            with span("engine.call"):
                pass
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, profiling.__file__)])
    finally:
        tracemalloc.stop()
    assert sum(s.size for s in snap.statistics("filename")) == 0


def test_nesting_gives_parent_and_root():
    with spans_on():
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):
            pass
        other = threading.Thread(target=lambda: span("f").__enter__())
        with span("g"):
            other.start()
            other.join(timeout=30)
    assert not other.is_alive()
    recs, dropped = take_spans()
    assert dropped == 0
    by = {r.name: (i, r) for i, r in enumerate(recs)}
    assert [r.name for r in recs][:5] == ["a", "b", "c", "d", "e"]
    parents = {n: r.parent for n, (_, r) in by.items()}
    assert parents == {"a": None, "b": 0, "c": 1, "d": 0, "e": None, "g": None, "f": None}
    roots = {n: r.root for n, (_, r) in by.items()}
    assert roots["a"] == roots["b"] == roots["c"] == roots["d"]
    assert len({roots["a"], roots["e"], roots["f"], roots["g"]}) == 4
    for name in "abcdeg":
        _, r = by[name]
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    assert by["f"][1].end_ns is None  # opened on its thread and never closed


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with spans_on():
        with span("a"):
            for _ in range(4):
                with span("b"):
                    pass
    recs, dropped = take_spans()
    assert [r.name for r in recs] == ["a", "b"] and dropped == 3
    assert take_spans() == ([], 0)


def test_spans_on_restores_the_previous_setting():
    with spans_on():
        with spans_on():
            assert profiling._on
        assert profiling._on
    assert not profiling._on


def _chrome_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_spans_are_user_annotations_on_the_recorders_clock(tmp_path):
    """Under a CPU profiler each span enters ``record_function``: its twin
    in the chrome trace (``baseTimeNanoseconds`` + ``ts`` x 1000) lies
    inside the recorder's own stamps."""
    from torch.profiler import ProfilerActivity, profile

    with spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            torch.ones(256, 256) @ torch.ones(256, 256)
            with span("inner"):
                torch.ones(64, 64) * 2
    recs, _ = take_spans()
    trace = _chrome_events(prof, tmp_path)
    base = trace["baseTimeNanoseconds"]
    twins = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    assert {r.name for r in recs} == {"outer", "inner"} <= set(twins)
    for r in recs:
        e = twins[r.name]
        start = base + e["ts"] * 1e3
        end = start + e["dur"] * 1e3
        assert r.start_ns <= start <= end <= r.end_ns, (r, start, end)


def test_trace_turns_spans_on(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with span("engine.call"):
            torch.ones(8) + 1
    assert not profiling._on
    (path,) = (tmp_path / "tr").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "engine.call" and e.get("cat") == "user_annotation"
               for e in events)
    assert take_spans() == ([], 0)  # the trace holds them; the recorder keeps none
    with spans_on():
        with span("train.step"):
            pass
        with profiling.trace(str(tmp_path / "tr2")):
            with span("engine.call"):
                pass
    # on before the trace: its spans stay for the caller to take
    assert [r.name for r in take_spans()[0]] == ["train.step", "engine.call"]
    with spans_on():
        with span("train.step"):
            pass
    with profiling.trace(str(tmp_path / "tr3")):
        with span("engine.call"):
            pass
    # off before it: what was recorded before is kept, the trace's spans are not
    assert [r.name for r in take_spans()[0]] == ["train.step"]


def _engine_call(engines):
    eng, size = engines["nin_gc_w4a4"]
    compiled = build_engine(eng, profile=(1, 4, 4), example_shape=(size, size, 3), device="cpu")
    x = _images(3, 3, size)  # a padded bucket
    return lambda: [compiled(x)]


def _int_forward(engines):
    def run():
        outs = []
        for eng, size in engines.values():
            with torch.no_grad():
                outs.append(eng(_images(4, 2, size)))
        return outs

    return run


def _train_step(engines):
    """A fresh trainer each call, built the same way, one step on the same
    augmented batch: every parameter, buffer and Adam moment after it."""
    make, quant, size = NETS["nin_gc_w4a4"]
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    offsets = torch.randint(0, 9, (8, 2), generator=gen)
    flips = torch.rand(8, generator=gen) < 0.5
    empty = Cifar10(np.zeros((0, 32, 32, 3), np.uint8), np.zeros((0,), np.int32),
                    np.zeros((0, 32, 32, 3), np.uint8), np.zeros((0,), np.int32), "test")

    def run():
        q = train_mode(prepare(make(torch.Generator().manual_seed(0)), QuantConfig(**quant),
                               inplace=True, device="cpu"))
        trainer = Trainer(q, TrainConfig(batch_size=8, log_every=0), dataset=empty,
                          device="cpu")
        trainer.train_step(data_lib.apply_augment(images, offsets, flips), labels)
        state = list(trainer.model.state_dict().values())
        moments = [v for s in trainer.optimizer.state.values() for k, v in s.items()
                   if k != "count"]
        return state + moments

    return run


@pytest.mark.parametrize("case", [_engine_call, _int_forward, _train_step],
                         ids=["engine_call", "int_forward", "train_step"])
def test_spans_on_change_no_bit(engines, case):
    run = case(engines)
    off = run()
    with spans_on():
        on = run()
    recs, dropped = take_spans()
    assert recs and dropped == 0
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_serialize_engine_round_trips_with_spans_on(engines):
    """Export traces no span (``torch.compiler.is_compiling``), so the
    artifact holds no profiler operator and runs as the module does."""
    eng, size = engines["nin_gc_w4a4"]
    x = _images(5, 2, size)
    with spans_on():
        data = serialize_engine(eng, 2, example_shape=(size, size, 3), platforms=("cpu",))
        assert take_spans() == ([], 0)
    run = deserialize_engine(data)
    assert "record_function" not in str(run.program.graph)
    with torch.no_grad():
        assert torch.equal(run(x), eng(x))


def _subtree(recs, index):
    """Indices of every span under ``recs[index]``."""
    out, frontier = set(), {index}
    while frontier:
        frontier = {i for i, r in enumerate(recs) if r.parent in frontier}
        out |= frontier
    return out


# on the CPU the convolutions run as f64 convolutions, with no patch matrix,
# unless the card's route (im2col and ``torch._int_mm``, which run on CPU
# tensors too) is forced; NIN-GC's shuffles are the model's, not a module's
@pytest.mark.parametrize("net,card_route,roles", [
    ("nin_gc_w4a4", False, {"int.quantize", "fn.shuffle", "int.gemm", "int.epilogue",
                            "int.pool"}),
    ("resnet_w8a8", False, {"int.quantize", "int.gemm", "int.epilogue", "int.pool"}),
    ("resnet_w8a8", True, {"int.quantize", "int.im2col", "int.gemm", "int.epilogue",
                           "int.pool"})])
def test_an_engine_call_records_its_three_parts_and_the_roles(engines, net, card_route, roles,
                                                              monkeypatch):
    if card_route:
        monkeypatch.setattr(_IntConvRoutes, "int_acc", _IntConvRoutes._int_acc_im2col)
    eng, size = engines[net]
    compiled = build_engine(eng, profile=(4, 4, 4), example_shape=(size, size, 3), device="cpu")
    with spans_on():
        compiled(_images(6, 4, size))
    recs, _ = take_spans()
    assert recs[0].name == "engine.call" and recs[0].parent is None
    children = [r.name for r in recs if r.parent == 0]
    assert children == ["engine.copy_in", "engine.replay", "engine.copy_out"]
    assert len({r.root for r in recs}) == 1
    replay = next(i for i, r in enumerate(recs) if r.name == "engine.replay")
    inside = {recs[i].name for i in _subtree(recs, replay)}
    assert inside == roles
    assert all(r.start_ns <= r.end_ns for r in recs)


def test_a_training_step_records_its_phases():
    run = _train_step(None)
    with spans_on():
        run()
    recs, _ = take_spans()
    names = [r.name for r in recs]
    assert names.count("train.augment") == 1 and names.count("train.step") == 1
    step = names.index("train.step")
    assert recs[names.index("train.augment")].parent is None
    top = [r.name for r in recs if r.parent == step]
    assert top == ["train.forward", "train.backward", "train.optimizer", "train.optimizer"]
    forward = names.index("train.forward")
    # the float step's shuffles, and no span of the integer engine
    assert {recs[i].name for i in _subtree(recs, forward)} == {"fn.shuffle"}
    assert recs[names.index("train.augment")].root != recs[step].root
