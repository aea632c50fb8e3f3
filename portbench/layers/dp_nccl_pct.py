"""The NCCL kernels' share of rank 0's traced window. A collective's
kernel runs from the moment it is launched until every rank has joined,
so the share counts waiting for the slowest rank as well as moving data."""

from portbench import readings


def read(run):
    st = readings.stretch_of(run, "train", multi=True)
    if st is None:
        return None
    nccl = readings.kernel_seconds(st, lambda n: "nccl" in n.lower())
    return 100.0 * nccl / st["window_s"]
