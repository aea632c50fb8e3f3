"""The card's idle share over the engine's traced calls."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "infer")
    return None if st is None else readings.idle_pct(st)
