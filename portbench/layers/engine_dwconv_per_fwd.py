"""Launches per engine call of kernels whose name holds ``dwconv``: one for
each depthwise conv that runs the hand-written depthwise kernel. None
where a call launches no such kernel (a program without it)."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "infer")
    if st is None:
        return None
    n = sum(1 for name, _ in st["kernels"] if "dwconv" in name)
    return readings.per_step(st, n) if n else None
