"""The engine GEMMs' share of their roofline: the least time the card
could take over the layers' GEMMs (work.engine_gemm_bound_s, from the
layer shapes, groups honoured) over the GEMM kernels' device time.

A kernel is a GEMM when its name says so: cuBLAS and CUTLASS GEMMs
(``gemm``, ``xmma``, ``cutlass``, ``wgmma``) and the hand-written int8
matmul K1 (``int8_small_kernel``, ``int8_gemm_kernel`` and its operand
passes ``int8_codes_kernel``, ``int8_wt_kernel``)."""

import re

from portbench import readings, work

_GEMM = re.compile(r"gemm|xmma|cutlass|wgmma|int8_(small|codes|wt)_kernel", re.IGNORECASE)


def is_gemm(name: str) -> bool:
    return bool(_GEMM.search(name))


def read(run):
    st = readings.stretch_of(run, "infer")
    if st is None:
        return None
    gemm_s = readings.kernel_seconds(st, is_gemm)
    if gemm_s <= 0:
        return None
    bound = work.engine_gemm_bound_s(work.arch_ops(run.config), run.window["batch"])
    return 100.0 * bound * st["steps"] / gemm_s
