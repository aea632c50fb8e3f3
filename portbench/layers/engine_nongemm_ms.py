"""Device ms per engine call of every kernel that is no GEMM: quantize,
requantize and epilogue passes, casts, im2col, shuffles, pools (the GEMM
rule is gemm_roofline_pct.infer's)."""

from portbench import harness, readings

_gemm = harness.load_module("layers", "gemm_roofline_pct.infer").is_gemm


def read(run):
    st = readings.stretch_of(run, "infer")
    if st is None:
        return None
    return readings.per_step(st, readings.kernel_seconds(st, lambda n: not _gemm(n))) * 1e3
