#!/usr/bin/env python3
"""Where K8/K9's time goes on one card: the kernel beside diagnostic builds
of it, and the host time of one wrapper call, part by part.

    python3 tools/w4_variants.py

Builds ``micronet_tpu_torch/ops/csrc/int4_matmul.cu`` through
``ops/_build.py`` as it is and with each of its diagnostic macros:

- ``W4_NO_COMPUTE``: every stage is still copied into shared memory, but no
  warp computes on it (the memory pipeline and the split sum alone);
- ``W4_NO_REDUCE``: no split's partial tile is summed (the kernel without
  its cross-block sum; split calls then give wrong outputs).

For each, the device time per call (``torch.profiler``, weights cold in L2
as in ``chip_smoke.py``) of K8 and K9 (group 128) at the five Llama-3-8B
shapes at M = 1 and 8, and a decode step's worth (129 calls at M = 8).

Then the host time (M = 8, K = N = 4096) of one ``int4_matmul`` call, of
one ``torch.matmul`` on a bf16 weight, and of each part of the wrapper,
beside the per-call work that a kept value saves (argtypes set on every
call, the card's properties read on every call, the workspace allocated on
every call, the scale reshaped on every call). Each is timed over calls queued behind a long kernel, so the
card does not pace them. Needs one card; the card's name and power limit
come first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from micronet_tpu_torch.ops import _build  # noqa: E402
from micronet_tpu_torch.ops import int4_matmul as im  # noqa: E402

VARIANTS = {"kernel": (), "no compute": ("W4_NO_COMPUTE",), "no reduce": ("W4_NO_REDUCE",)}
GROUP = 128
HOST_CALLS = 300


def device_times(libs: dict, dev: torch.device, gen: torch.Generator) -> None:
    data = {}
    for (k, n), _ in cs.K3_SHAPES:
        copies = cs.copies_for(k // 2 * n + k // GROUP * n * 4)
        data[k, n] = [(torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=dev,
                                     generator=gen),
                       torch.rand((n,), device=dev, generator=gen),
                       torch.rand((k // GROUP, n), device=dev, generator=gen))
                      for _ in range(copies)]
    for name, lib in libs.items():
        for label, entry, pick, group in (("K8", "mn_int4_matmul", 1, 0),
                                          ("K9", "mn_int4_matmul_grouped", 2, GROUP)):
            def call(x, packed, scale, entry=entry, group=group, lib=lib):
                return im._plain_call(entry, x, packed, scale, group, lib)

            step = 0.0
            for m in (1, 8):
                per_shape = []
                for (k, n), per_step in cs.K3_SHAPES:
                    x = torch.randn((m, k), device=dev, generator=gen)
                    ms = cs.device_ms(call, [(x, c[0], c[pick]) for c in data[k, n]], 60)
                    per_shape.append(f"{k}x{n} {ms * 1e3:.1f}")
                    step += ms * per_step if m == 8 else 0.0
                print(f"{name:10s} {label} M={m}: device us per call: " + ", ".join(per_shape))
            print(f"{name:10s} {label} decode step (129 calls at M=8): {step:.3f} ms of device "
                  "time")


def host_us(fn) -> float:
    """Mean host time (us) of ``fn()`` over calls queued behind a long kernel."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # the calls below queue behind it
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def host_times(dev: torch.device, gen: torch.Generator) -> None:
    m, k, n = 8, 4096, 4096
    x = torch.randn((m, k), device=dev, generator=gen)
    packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=dev, generator=gen)
    scale = torch.rand((n,), device=dev, generator=gen)
    xb = x.to(torch.bfloat16)
    w_bf16 = torch.randn((k, n), device=dev, dtype=torch.bfloat16, generator=gen)
    lib = _build.load("int4_matmul", im._LIB_SIGNATURES)
    launch = lib.mn_int4_matmul
    splits = im._w4_splits(k // 2, n, _build.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    counters = im._w4_counters(dev, stream, n // im._W4_BLOCK_N)
    ptrs = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), m, k, n, splits, 1, stream)

    def bind_per_call():  # what _build.load did on every call before it bound once
        for fn, argtypes in im._LIB_SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int

    def checks():
        _build.check_operand("x", x, torch.float32, dev)
        _build.check_operand("packed", packed, torch.int8, dev)
        _build.check_operand("scale", scale, torch.float32, dev, align=16)

    parts = [
        ("int4_matmul, the whole call", lambda: im.int4_matmul(x, packed, scale)),
        ("torch.matmul on the bf16 weight", lambda: torch.matmul(xb, w_bf16)),
        ("an empty call (the timing loop)", lambda: None),
        ("the three operand checks", checks),
        ("library lookup, bound once (_build.load)",
         lambda: _build.load("int4_matmul", im._LIB_SIGNATURES).mn_int4_matmul),
        ("argtypes set on every call (no cache)", bind_per_call),
        ("SM count, cached (_build.sm_count)", lambda: _build.sm_count(dev)),
        ("SM count, device properties read per call",
         lambda: torch.cuda.get_device_properties(dev).multi_processor_count),
        ("split rule (_w4_splits)", lambda: im._w4_splits(k // 2, n, 132)),
        ("output, torch.empty", lambda: torch.empty((m, n), dtype=torch.float32, device=dev)),
        ("output, x.new_empty", lambda: x.new_empty((m, n))),
        ("workspace, x.new_empty (no cache)", lambda: x.new_empty((splits, m, n))),
        ("workspace, kept (_w4_workspace)", lambda: im._w4_workspace(dev, stream, 132)),
        ("scale, reshape(-1).contiguous()", lambda: scale.reshape(-1).contiguous()),
        ("counters lookup", lambda: im._w4_counters(dev, stream, n // im._W4_BLOCK_N)),
        ("stream, torch.cuda.current_stream", lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("stream, raw handle", lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        ("six data_ptr()", lambda: (x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), ws.data_ptr(), counters.data_ptr())),
        ("the ctypes launch alone", lambda: launch(*ptrs)),
        ("the ctypes launch and its check", lambda: _build.check(launch(*ptrs), "int4_matmul")),
    ]
    for label, fn in parts:
        print(f"host us per call (M=8, K=N=4096): {label}: {host_us(fn):.2f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("w4_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    started = {name: _build._start("int4_matmul", d) for name, d in VARIANTS.items()}
    for name, (st, out) in started.items():  # all nvcc runs at once
        if st is not None:
            _build._finish("int4_matmul", st, out)
    libs = {name: _build.load("int4_matmul", im._LIB_SIGNATURES, d)
            for name, d in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    device_times(libs, dev, gen)
    host_times(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
