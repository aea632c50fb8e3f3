"""Launches per engine call of the integer engine's hand-written patch
gathers (kernels whose name holds ``patch_matrix_kernel`` or
``patch_shuffle_kernel``): one for each conv whose GEMM operand is not a
view of its codes (a k x k or strided conv, the first layer's f32
patches) and one for each channel shuffle of int8 codes. None where a
call launches no such kernel (a program without them)."""

from portbench import readings

NAMES = ("patch_matrix_kernel", "patch_shuffle_kernel")


def read(run):
    st = readings.stretch_of(run, "infer")
    if st is None:
        return None
    n = sum(1 for name, _ in st["kernels"] if any(k in name for k in NAMES))
    return readings.per_step(st, n) if n else None
