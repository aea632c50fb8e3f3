"""The program's own spans (``micronet_tpu_torch.utils.profiling.span``),
measured once per traced run for the readers of ``host_*ms.*``,
``engine_*_ms`` and ``train_*_ms``, after the runner and from the same
seed, in a process of their own: once a profiler session has run in a
process, every CUDA call of it costs the host more (an engine replay's
launch 0.05 ms before the runner's traced stretch, 0.33 ms after it), so
the host's times are taken where no profiler ever ran, before the
profiled stretch of the same process.

- Engine cells: the engine is built again as the runner builds it. First
  ``HOST_CALLS`` calls run with spans on and no profiler, each as the
  window calls it: the host's time of ``engine.call`` and its parts. Then
  one eager forward of ``engine.model`` on a pool batch runs under the
  profiler with spans on; its kernels and copies, in launch order, each
  take the role of the innermost ``int.*`` span that held their launch
  (the models' channel shuffle, ``fn.shuffle``, takes ``int.im2col``: it
  is the data movement a patch matrix is). A replay launches the kernels
  of the forward it captured, so the labels go onto the runner's traced
  replays by position, call by call, once the kernels are seen to match
  one for one (else the engine readers find nothing). A graph runs some
  of the forward's device-to-device copies as kernels of its own
  (``memcpy32_post``): such a replay kernel stands for the forward's copy
  at its place; the forward's other copies stay copies in the replay,
  outside the kernels the runner traced.
- The one-card training cell: the trainer is built again and fed as the
  runner feeds it, warmed by the traffic's ``check_steps`` steps. First
  ``HOST_STEPS`` steps with spans on and no profiler, each after a
  synchronize, so that the host's time of ``train.augment`` and
  ``train.step`` is its own and not a wait for the card. Then
  ``trace_steps`` steps run under the profiler with spans on: each kernel
  goes to the spans whose host interval holds its launch (the runtime
  call of the same ``correlation``, on any thread: autograd launches the
  backward from its own), and each span name sums the device time of the
  kernels it holds.

A program without spans (``utils.profiling.spans_on`` missing) reads
nothing, and nothing is measured. Like ``program.py``, this module imports
the program only inside functions. The result is kept on the run as
``run.spans``; a one-line summary goes to standard error.

    python3 -m portbench.spans < spec.json    # the measuring process
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import harness, readings, tracing

PREFIXES = ("engine.", "int.", "fn.", "train.")
# the engine's roles of the program's spans that no ``Int*`` module opens
ROLES = {"fn.shuffle": "int.im2col"}
# the host-only stretches' counts: no profiler, so many samples cost
# seconds (an engine call waits for the card, 28 to 65 ms; a step 72 ms)
HOST_CALLS = 200
HOST_STEPS = 50
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def program_spans(events: Sequence[dict]) -> List[Tuple[str, float, float]]:
    """``(name, start, end)`` in us of the program's spans in a chrome
    trace: the ``user_annotation`` events a span enters under the
    profiler."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and str(e.get("name", "")).startswith(PREFIXES)]


class DeviceOp(NamedTuple):
    """A kernel (or, where asked for, a copy) of a trace: its name and
    device seconds, and the names of the program spans whose host interval
    holds its launch, innermost first."""

    name: str
    seconds: float
    spans: List[str]
    copy: bool = False


def kernels_by_span(events: Sequence[dict], copies: bool = False) -> List[DeviceOp]:
    """Every kernel of a chrome trace (and with ``copies`` every memcpy) in
    the order it ran. A launch is the runtime call of the same
    ``correlation``, on whatever thread; ``spans`` is empty where no
    program span holds it or the launch is not in the trace."""
    spans = program_spans(events)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in _RUNTIME_CATS and "correlation" in e.get("args", {})}
    cats = ("kernel", "gpu_memcpy") if copies else ("kernel",)
    out = []
    for e in sorted((e for e in events if e.get("cat") in cats and e.get("ph") == "X"),
                    key=lambda e: float(e["ts"])):
        t = launch.get(e.get("args", {}).get("correlation"))
        holding = [] if t is None else sorted(
            (s for s in spans if s[1] <= t <= s[2]), key=lambda s: s[2] - s[1])
        out.append(DeviceOp(e["name"], float(e["dur"]) * 1e-6, [s[0] for s in holding],
                            e.get("cat") == "gpu_memcpy"))
    return out


def role(spans: Sequence[str]) -> str:
    """The engine's role of a kernel launched inside ``spans`` (innermost
    first): the innermost ``int.*`` span or one that ``ROLES`` maps, else
    ``""``."""
    for s in spans:
        if s.startswith("int.") or s in ROLES:
            return ROLES.get(s, s)
    return ""


def span_seconds(kernels: Sequence[DeviceOp]) -> Dict[str, float]:
    """Device seconds by span name: each kernel counts once for every name
    among the spans that hold its launch (so ``train.step`` holds its
    phases); ``""`` sums the kernels no span holds."""
    out: Dict[str, float] = {}
    for k in kernels:
        for name in set(k.spans) or {""}:
            out[name] = out.get(name, 0.0) + k.seconds
    return out


def replay_labels(eager: Sequence[Tuple[str, str, bool]], kernels: Sequence[Sequence],
                  calls: int) -> Optional[Dict[str, float]]:
    """Device seconds a call by label, from the traced replays ``kernels``
    (``[name, seconds]`` of ``calls`` calls in launch order) and one eager
    forward's ``(name, label, copy)`` in launch order. Call by call, each
    replay kernel takes the label of the forward's next kernel of the same
    name, or, where it is a graph's copy kernel, of the forward's next
    copy; the forward's copies passed over ran as copies in the replay.
    None unless every call's kernels meet the forward's so, one for one,
    and leave none of its kernels over."""
    if not eager or calls <= 0 or len(kernels) % calls:
        return None
    n = len(kernels) // calls
    out: Dict[str, float] = {}
    for c in range(calls):
        j = 0
        for name, s in kernels[c * n:(c + 1) * n]:
            is_copy = name.startswith("memcpy")  # a graph's kernel for a captured copy
            while j < len(eager) and eager[j][2] and not is_copy:
                j += 1
            if j == len(eager) or eager[j][2] != is_copy or (
                    not is_copy and eager[j][0] != name):
                return None
            out[eager[j][1]] = out.get(eager[j][1], 0.0) + s / calls
            j += 1
        if any(not copy for _, _, copy in eager[j:]):
            return None
    return out


def host_ms(records, names: Sequence[str]) -> List[float]:
    """Per root (an engine call, a training step, an augmentation), the
    host ms of the spans named ``names`` summed, for each root that has
    one, in order."""
    per_root: Dict[int, float] = {}
    for r in records:
        if r.name in names and r.end_ns is not None:
            per_root[r.root] = per_root.get(r.root, 0.0) + (r.end_ns - r.start_ns) * 1e-6
    return list(per_root.values())


def _profiled(step: Callable[[], object], steps: int, device) -> List[dict]:
    """The chrome-trace events of ``steps`` calls of ``step`` under the
    profiler (CPU and, on a card, CUDA activity), ending in a synchronize,
    inside the stretch annotation the runners' traces use."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(tracing.STRETCH):
            for _ in range(steps):
                step()
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiling():
    """The program's profiling module where it records spans, else None."""
    from micronet_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans_on") else None


def _engine(run, profiling, calls: int) -> Dict:
    from .traffic import engine_closed

    device = run.device
    _, _, _, pool, engine = engine_closed.setup(run, device)
    with torch.no_grad():
        for i in range(2):
            engine(pool[i % pool.shape[0]])
        _sync(device)
        profiling.take_spans()
        with profiling.spans_on():
            for k in range(calls):
                engine(pool[k % pool.shape[0]])
                _sync(device)
        records, dropped = profiling.take_spans()
        with profiling.spans_on():
            events = _profiled(lambda: engine.model(pool[0]), 1, device)
        profiling.take_spans()
    eager = [(k.name, role(k.spans), k.copy) for k in kernels_by_span(events, copies=True)]
    return dict(kind="infer", eager=eager, dropped=dropped,
                host_ms={"engine.call": host_ms(records, ("engine.call",)),
                         "engine.replay": host_ms(records, ("engine.replay",)),
                         "copy": host_ms(records, ("engine.copy_in", "engine.copy_out"))})


def _train(run, profiling, steps: int) -> Dict:
    from . import program, weights, work
    from .traffic import train_steps

    device, tr = torch.device(run.device), run.traffic
    ops = work.arch_ops(run.config)
    gen = weights.generator(run.seed, device)
    w = weights.make_weights(ops, gen, device)
    images, labels = weights.uint8_set(gen, device, tr["dataset"])
    feed = train_steps._feed(images, labels, tr["batch"], gen,
                             weights.generator(run.seed + 1, device), device)
    trainer = program.trainer(run.config, w, tr, None, device)

    def step():
        x, y, _ = next(feed)
        return trainer.train_step(x, y)[0]

    for _ in range(tr["check_steps"]):
        step()
    _sync(device)
    profiling.take_spans()
    with profiling.spans_on():
        for _ in range(steps):
            _sync(device)
            step()
        _sync(device)
    records, dropped = profiling.take_spans()
    with profiling.spans_on():
        events = _profiled(step, tr["trace_steps"], device)
    profiling.take_spans()
    kernels = kernels_by_span(events)
    n = tr["trace_steps"]
    device_s = {k: v / n for k, v in span_seconds(kernels).items()}
    phases = ("train.augment", "train.forward", "train.backward", "train.optimizer")
    total = sum(k.seconds for k in kernels) / n
    augment, step_ms = host_ms(records, ("train.augment",)), host_ms(records, ("train.step",))
    out = dict(kind="train", device_s=device_s, kernels_per_step=len(kernels) / n,
               dropped=dropped, host_ms={"train.augment": augment, "train.step": step_ms,
                                         "step": [a + s for a, s in zip(augment, step_ms)]},
               gaps=tracing.summarize(events)["idle_gaps"])
    if total > 0:
        out["coverage"] = sum(device_s.get(p, 0.0) for p in phases) / total
    return out


def _measure_here() -> None:
    """The measuring process: the run's spec (cell, seed, device, the
    configuration and traffic as the runner had them, the host stretch's
    count) on standard input, its measurement as one JSON line on standard
    output."""
    spec = json.loads(sys.stdin.read())
    run = harness.make_run(spec["cell"], spec["seed"], 0.0, True, time.time(),
                           device=spec["device"], root=Path(spec["root"]))
    run.config, run.traffic = spec["config"], spec["traffic"]
    measure_in = _engine if spec["kind"] == "infer" else _train
    print(json.dumps(measure_in(run, _profiling(), spec["count"])), flush=True)


def _in_a_process_of_their_own(run, kind: str) -> Optional[Dict]:
    spec = dict(cell=run.cell, seed=run.seed, device=str(run.device), root=str(run.root),
                kind=kind, count=HOST_CALLS if kind == "infer" else HOST_STEPS,
                config=run.config, traffic=run.traffic)
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    done = subprocess.run([sys.executable, "-m", "portbench.spans"], input=json.dumps(spec),
                          stdout=subprocess.PIPE, text=True, cwd=harness.ROOT)
    if done.returncode or not done.stdout.strip():
        print(f"portbench: the spans' process failed ({done.returncode})", file=sys.stderr,
              flush=True)
        return None
    out = json.loads(done.stdout.strip().splitlines()[-1])
    if kind == "infer":
        eager = out.pop("eager")
        st = run.stretch
        labels = None if st is None else replay_labels(eager, st["kernels"], st["steps"])
        out.update(labels_s=labels, eager_kernels=sum(not c for _, _, c in eager),
                   eager_copies=sum(c for _, _, c in eager))
        if labels:
            out["coverage"] = 1.0 - labels.get("", 0.0) / sum(labels.values())
    return out


def measure(run) -> Optional[Dict]:
    """The spans of this run's cell, measured once and kept on the run;
    None for a program without spans, an untraced run, the data-parallel
    cell, or a measuring process that failed."""
    if "spans" in vars(run):
        return run.spans
    run.spans = None
    kind = run.window.get("kind")
    if not run.trace or kind not in ("infer", "train") or run.window.get("ranks", 1) != 1:
        return None
    if _profiling() is None:
        return None
    run.spans = _in_a_process_of_their_own(run, kind)
    if run.spans is None:
        return None
    summary = {k: v for k, v in run.spans.items() if k != "host_ms"}
    summary["host_ms_median"] = {k: statistics.median(v) for k, v in run.spans["host_ms"].items()
                                 if v}
    w = run.window  # the measured window's own ms a call or step, beside the host's
    summary["window_ms"] = 1e3 * w["seconds"] / w["calls" if kind == "infer" else "steps"]
    print(f"portbench: spans {json.dumps(summary)}", file=sys.stderr, flush=True)
    return run.spans


def median_host_ms(run, kind: str, name: str) -> Optional[float]:
    """In a one-card run of ``kind``, the median over the measured calls or
    steps of ``host_ms[name]``."""
    if run.window.get("kind") != kind or run.window.get("ranks", 1) != 1:
        return None
    spans = measure(run)
    values = None if spans is None else spans["host_ms"].get(name)
    return statistics.median(values) if values else None


def engine_label_ms(run, label: str) -> Optional[float]:
    """Device ms a call of the traced replays' kernels labelled ``label``."""
    if readings.stretch_of(run, "infer") is None:
        return None
    spans = measure(run)
    if spans is None or not spans["labels_s"]:
        return None
    return spans["labels_s"].get(label, 0.0) * 1e3


def train_span_ms(run, name: str) -> Optional[float]:
    """Device ms a one-card training step of the kernels the span ``name``
    holds."""
    if readings.stretch_of(run, "train", multi=False) is None:
        return None
    spans = measure(run)
    if spans is None or "coverage" not in spans:
        return None
    return spans["device_s"].get(name, 0.0) * 1e3


if __name__ == "__main__":
    _measure_here()
