"""The traced stretch: ``torch.profiler`` over a few steady calls after the
measured window, reduced to what the per-layer readers need.

The stretch runs inside one ``portbench.stretch`` annotation that ends in
a synchronize, so its span on the host clock is the traced window. The
device's busy time is the union of its kernels', copies' and memsets'
intervals inside that span (kernels of several streams may overlap). An
idle gap is named after the innermost host operation running at its
middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

STRETCH = "portbench.stretch"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(events: List[dict]) -> Dict:
    """The stretch's summary from chrome-trace events (times in us):
    ``window_s``, ``busy_s``, ``kernels`` as ``[name, seconds]`` in launch
    order, ``device_ops`` (the ten longest by total time) and
    ``idle_gaps`` (the ten longest, named by the host's operation)."""
    spans = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"]
    if not spans:
        raise RuntimeError("the trace holds no stretch annotation")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"
           and t0 <= float(e["ts"]) <= t1]
    dev.sort(key=lambda e: float(e["ts"]))
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), t1)) for e in dev])
    kernels = [[e["name"], float(e["dur"]) * 1e-6] for e in dev if e.get("cat") == "kernel"]
    totals: Dict[str, float] = {}
    for name, s in kernels:
        totals[name] = totals.get(name, 0.0) + s
    host = [e for e in events if e.get("cat") in _HOST_CATS and e.get("ph") == "X"
            and e.get("name") != STRETCH]
    edges = [t0] + [x for span in busy for x in span] + [t1]
    longest = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                      if edges[i + 1] > edges[i]), reverse=True)[:10]
    gaps = []
    for length, s in longest:
        mid = s + length / 2
        inner = [h for h in host if float(h["ts"]) <= mid <= float(h["ts"]) + float(h["dur"])]
        name = min(inner, key=lambda h: float(h["dur"]))["name"] if inner else "host (no op)"
        gaps.append([name, length * 1e-6])
    return dict(window_s=(t1 - t0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
                kernels=kernels,
                device_ops=sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:10],
                idle_gaps=gaps)


def trace_stretch(step: Callable[[], None], steps: int, device) -> Dict:
    """Run ``step`` ``steps`` times under the profiler and summarize. The
    trace file goes to the temporary directory and is removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            for _ in range(steps):
                step()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = summarize(events)
    out["steps"] = steps
    return out
