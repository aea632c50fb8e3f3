"""The card's idle share over traced training steps on one card."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "train", multi=False)
    return None if st is None else readings.idle_pct(st)
