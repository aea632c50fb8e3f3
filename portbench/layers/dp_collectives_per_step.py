"""NCCL kernels per data-parallel step on rank 0 (each collective the
trainer issues runs one)."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "train", multi=True)
    if st is None:
        return None
    return readings.per_step(st, sum(1 for name, _ in st["kernels"] if "nccl" in name.lower()))
