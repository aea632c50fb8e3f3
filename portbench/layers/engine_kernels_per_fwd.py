"""Kernels launched per engine call (a replay launches every kernel of the
eager forward)."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "infer")
    return None if st is None else readings.per_step(st, len(st["kernels"]))
