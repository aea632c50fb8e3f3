"""Readings that set the limits of ``correct``, at a cell's own size, on
several seeds in one process: the program's numbers (the cell's own
set-up and a short window, exactly as a run compares them), and the
numbers of the control and of planted faults, each against the
reference:

- the control: the reference itself in the program's place, computed one
  step below the configuration's precision: the engine cells' integer
  codes at int4 for W8A8 and one bit narrower for W4A4 (W3A3); the
  training cells' whole step in bfloat16 instead of float32;
- engine faults, planted in the reference put in the program's place:
  ``one_bit_narrower`` (W7A7 for W8A8; for W4A4 it is the control),
  ``bf16_epilogue`` (the stated codes, every layer's output rounded to
  bfloat16, as a requant epilogue computed in bfloat16 would leave it) and
  ``answer_altered`` (the last answer of every batch reversed and moved
  by 1, as the CPU fault test plants it in the program);
- training faults, planted in the reference put in the program's place:
  ``half_batch`` (half of each batch left out, the mean taken over the
  rest) and, for several ranks, ``no_exchange`` (rank 0's own rows in
  the loss, the batch statistics still global: the gradient all-reduce
  left out). A step that returns its state unchanged reads 1 by
  ``step_gap`` and needs no run.

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3 [--program 0|1]

One JSON line a seed; the program's numbers are skipped with ``--program 0``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from portbench import compare, harness, weights, work  # noqa: E402
from portbench.reference.train import run_steps  # noqa: E402

# the control's bits, one step below the configuration's: int4 below int8;
# below int4, one bit narrower
CONTROL_BITS = {4: 3, 8: 4}


def engine_control(run) -> dict:
    """The control's and the planted faults' numbers against the
    reference, over the cell's pool."""
    from portbench.traffic import engine_closed

    tr, device = run.traffic, run.device
    ops = work.arch_ops(run.config)
    gen = weights.generator(run.seed, device)
    w = weights.make_weights(ops, gen, device)
    calib = weights.gaussian_images(gen, device, tr["calib_steps"], tr["calib_batch"])
    pool = weights.gaussian_images(gen, device, tr["pool"], tr["batch"])
    quant = run.config["quant"]
    ref = engine_closed.reference_logits(ops, w, calib, pool, quant, "exact")
    low = {k: CONTROL_BITS[quant[k]] for k in ("a_bits", "w_bits")}
    ctrl = engine_closed.reference_logits(ops, w, calib, pool, low, "exact")
    out = {"control": compare.engine_numbers(list(enumerate(ctrl)), ref)[0]}
    narrower = {k: quant[k] - 1 for k in ("a_bits", "w_bits")}
    faults = [("bf16_epilogue", quant, torch.bfloat16)]
    if narrower != low:
        faults.insert(0, ("one_bit_narrower", narrower, None))
    for name, bits, epilogue in faults:
        other = engine_closed.reference_logits(ops, w, calib, pool, bits, "exact", epilogue)
        out[name] = compare.engine_numbers(list(enumerate(other)), ref)[0]
    altered = [r.clone() for r in ref]
    for r in altered:
        r[-1] = r[-1].flip(0) + 1.0
    out["answer_altered"] = compare.engine_numbers(list(enumerate(altered)), ref)[0]
    return out


def train_control(run) -> dict:
    """The control's and the planted faults' numbers against the reference,
    over the cell's first steps from the same inputs."""
    from portbench.traffic import train_steps

    tr, device = run.traffic, torch.device(run.device)
    ops = work.arch_ops(run.config)
    gen = weights.generator(run.seed, device)
    w = weights.make_weights(ops, gen, device)
    images, labels = weights.uint8_set(gen, device, tr["dataset"])
    feed = train_steps._feed(images, labels, tr["batch"], gen,
                             weights.generator(run.seed + 1, device), device)
    records = [next(feed)[2] for _ in range(tr["check_steps"])]

    def steps(dtype=torch.float32, batches=records, loss_rows=None):
        net = train_steps.reference_net(run, ops, w, device, dtype)
        return run_steps(net, batches, tr["lr"], tr["weight_decay"], loss_rows)

    def as_program(r):
        return dict(losses=r["losses"], grad=compare.norms(r["grad"]),
                    delta=compare.norms(r["delta"]))

    ref = steps()
    out = {"control": compare.train_numbers(as_program(steps(torch.bfloat16)), ref)}
    half = [tuple(t[:t.shape[0] // 2] for t in rec) for rec in records]
    out["half_batch"] = compare.train_numbers(as_program(steps(batches=half)), ref)
    ranks = int(tr["ranks"])
    if ranks > 1:
        out["no_exchange"] = compare.train_numbers(
            as_program(steps(loss_rows=tr["batch"] // ranks)), ref)
    return out


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
            run = harness.make_run(args.workload, seed, 1.0, False, time.time())
            harness.traffic_runner(run.traffic["runner"]).run(run)
            line["program"] = run.numbers
        run = harness.make_run(args.workload, seed, 1.0, False, time.time())
        kind = run.traffic["runner"]
        line.update(engine_control(run) if kind == "engine_closed" else train_control(run))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
