"""``engine_closed``'s closed loop (one caller, back-to-back batches through
the integer engine's one CUDA-graph bucket) with one difference: the
plain reference the timed calls are compared with is the configuration's
network class, ``reference/archs/<arch>.py::Net``, where that module has
one (a net whose layers :class:`..reference.iao.IaoNet` alone does not
run, such as MobileNetV2's ReLU6s and linear-bottleneck adds), else
``IaoNet``. The set-up, the window, the trace and the comparison are
``engine_closed``'s own, run with that class in place of ``IaoNet``.

Mix parameters: ``engine_closed``'s.

    python3 -m portbench.traffic.engine_closed_arch --workload <cell> --seeds 1 2 3 [--program 0|1]

prints, a seed a line, the readings that set the cell's limits, as
``controls.py`` does for ``engine_closed``'s cells: the program's numbers
(the cell's set-up and a short window) and :func:`control`'s.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from unittest import mock

import torch

from . import engine_closed
from .. import controls, harness
from ..reference.iao import IaoNet


def net_class(config: dict):
    """The reference network class of ``config['arch']``."""
    mod = importlib.import_module(f"portbench.reference.archs.{config['arch']}")
    return getattr(mod, "Net", IaoNet)


@contextlib.contextmanager
def _reference(config: dict):
    """``engine_closed``'s reference (and so its ``reference_logits``)
    built from the configuration's network class for the duration."""
    with mock.patch.object(engine_closed, "IaoNet", net_class(config)):
        yield


def run(run) -> None:
    with _reference(run.config):
        engine_closed.run(run)


def control(run) -> dict:
    """The control's and the planted faults' numbers against this reference
    over the cell's pool: the int4 control, ``one_bit_narrower`` (W7A7 for
    W8A8), ``bf16_epilogue`` and ``answer_altered``, as ``controls.py``
    reads them for ``engine_closed``'s cells."""
    with _reference(run.config):
        return controls.engine_control(run)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        line = {"seed": seed}
        if args.program:
            r = harness.make_run(args.workload, seed, 1.0, False, time.time())
            run(r)
            line["program"] = r.numbers
        line.update(control(harness.make_run(args.workload, seed, 1.0, False, time.time())))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
