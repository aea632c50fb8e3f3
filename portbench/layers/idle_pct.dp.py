"""Rank 0's card idle share over traced data-parallel steps."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "train", multi=True)
    return None if st is None else readings.idle_pct(st, "busy_s_rank0")
