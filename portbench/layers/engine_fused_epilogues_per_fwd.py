"""Launches per engine call of the integer engine's one-pass conv epilogue
(kernels whose name holds ``requant_epilogue``): one for each symmetric
``IntConv2d`` whose epilogue runs as the hand-written kernel. None where a
call launches no such kernel (a program without it)."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "infer")
    if st is None:
        return None
    n = sum(1 for name, _ in st["kernels"] if "requant_epilogue" in name)
    return readings.per_step(st, n) if n else None
