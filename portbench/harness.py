"""The harness: it finds a cell's files by name, checks for the cards,
hands the cell to its traffic runner, reads the metrics that
``BENCHMARK.json`` names for the cell through their readers, and prints
the result.

Files, each found by its name:

- ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips`` and the
  ``limits`` of the numbers that decide ``correct``;
- ``configs/<config>.json``: the model, its quantization and the source;
- ``traffic/<traffic>.json``: the mix's parameters, with ``runner``, the
  name of ``traffic/<runner>.py``, whose ``run(run)`` sets up, measures,
  traces and checks, filling the :class:`Run`;
- ``end_to_end/<metric>.py`` and ``layers/<metric>.py``: ``read(run)``,
  which returns the metric's value or None where it finds nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "micronet_tpu")


@dataclasses.dataclass
class Run:
    """One run of one cell: its files and arguments, and what the runner
    found. Readers read it."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    spec: dict  # workloads/<cell>.json
    config: dict
    traffic: dict
    t_start: float  # the process's start, time.time()
    device: str = "cuda"
    root: Path = HERE  # the folder the cell's files were found in
    # filled by the runner
    setup_s: Optional[float] = None
    window: Dict = dataclasses.field(default_factory=dict)
    stretch: Optional[Dict] = None  # tracing.summarize of rank 0, with busy_s averaged
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)  # all compared
    checks: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    cards: int = 1
    card_name: str = ""

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim
                                         for _, v, lim in self.checks)


def load_json(*parts: str, root: Path = HERE) -> dict:
    with open(root.joinpath(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str, root: Path = HERE) -> ModuleType:
    """``<folder>/<name>.py`` under ``root``, imported by its path (a
    metric's name may hold dots)."""
    path = root / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_runner(name: str) -> ModuleType:
    """``traffic/<name>.py``, imported as a module of the package (its rank
    entry points are pickled by name into spawned processes)."""
    return importlib.import_module(f"portbench.traffic.{name}")


def make_run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", root: Path = HERE) -> Run:
    spec = load_json("workloads", f"{cell}.json", root=root)
    return Run(cell=cell, seed=seed, seconds=seconds, trace=trace, spec=spec,
               config=load_json("configs", f"{spec['config']}.json", root=root),
               traffic=load_json("traffic", f"{spec['traffic']}.json", root=root),
               t_start=t_start, device=device, root=root)


def metric_names(bench: dict, cell: str, trace: bool) -> List[Tuple[str, str]]:
    """``(name, unit)`` of the metrics the cell reports in this run: the
    end-to-end ones untraced, the per-layer ones traced; a metric with a
    ``workloads`` list only in those cells, else in every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return [(m["name"], m["unit"]) for m in e2e]
    moved = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def read_metrics(run: Run, names: List[Tuple[str, str]]) -> Dict[str, dict]:
    folder = "layers" if run.trace else "end_to_end"
    out = {}
    for name, unit in names:
        value = load_module(folder, name, run.root).read(run)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def phase(what: str, since: float) -> float:
    """Print how long a set-up phase took (standard error); returns now."""
    now = time.time()
    print(f"portbench: {what} {now - since:.2f} s", file=sys.stderr, flush=True)
    return now


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result(run: Run, metrics: Dict[str, dict]) -> dict:
    device = {"platform": "gpu", "kind": run.card_name, "count": run.cards,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.stretch is not None:
        device.update(busy_s=run.stretch["busy_s"], window_s=run.stretch["window_s"])
        limit = power_limit_w()
        if limit is not None:
            device["power_limit_w"] = limit
        out["breakdown"] = {"device_ops": run.stretch["device_ops"],
                            "idle_gaps": run.stretch["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    t = phase("interpreter and torch", t_start)
    run = make_run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    need = int(run.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {need} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    run.card_name = torch.cuda.get_device_name(0)
    # the configurations state float32 where they state no lowering: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = traffic_runner(run.traffic["runner"])
    phase("CUDA and the program's import", t)
    runner.run(run)
    metrics = read_metrics(run, metric_names(load_bench(), run.cell, run.trace))
    found = forbidden_modules() + run.window.get("forbidden", [])
    if found:
        print(f"portbench: the run loaded {sorted(set(found))}", file=sys.stderr)
        return 3
    for name, v, lim in run.checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result(run, metrics)))
    return 0


def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
