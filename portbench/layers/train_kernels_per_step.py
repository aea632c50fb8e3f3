"""Kernels launched per training step on one card."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "train", multi=False)
    return None if st is None else readings.per_step(st, len(st["kernels"]))
