"""Tiny CPU versions of the benchmark's cells for the tests: the
published op lists at small widths, small batches and short windows."""

import time

from portbench import harness

TINY_NIN = [64] * 8


def tiny_run(cell: str, seed: int = 5, seconds: float = 0.3, trace: bool = False, **traffic):
    run = harness.make_run(cell, seed, seconds, trace, time.time(), device="cpu")
    if run.config["arch"] == "nin_gc":
        run.config["widths"] = TINY_NIN
        run.config["model"]["kwargs"] = {"cfg": TINY_NIN}
    if run.traffic["runner"] == "engine_closed":
        run.traffic.update(batch=4, pool=2, calib_batch=4, calib_steps=2, trace_calls=2)
    else:
        run.traffic.update(batch=4 * run.traffic["ranks"], dataset=64, trace_steps=2)
    run.traffic.update(traffic)
    return run


def drive(run, **kw):
    harness.traffic_runner(run.traffic["runner"]).run(run, **kw)
    return run
