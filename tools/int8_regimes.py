#!/usr/bin/env python3
"""K1's and K2's two regimes side by side on one card, by device time, at
the calls of ``chip_smoke.py`` and around the boundary that
``ops/int_matmul.py::_k1_regime`` draws.

    python3 tools/int8_regimes.py
    python3 tools/int8_regimes.py --tree DIR

At each call (M, K, N), the device time per call (``torch.profiler``,
through ``chip_smoke.device_ms``) of K1 and of K2 in the small regime (one
mma.sync kernel) and in the GEMM regime (the codes and weight pre-passes,
then the wgmma GEMM, each kernel's share in brackets), each forced, beside
``torch._int_mm`` on codes made beforehand (the integer product only), with
the regime ``_k1_regime`` picks. K1's inputs
are ``chip_smoke.k1_args`` at s_x = 0.05, zp = 0, A8; K2's
``chip_smoke.k2_args``.

``--tree DIR`` imports ``micronet_tpu_torch`` from another checkout (an
older commit unpacked with ``git archive``) and times its public
``int8_matmul_dequant`` and ``binary_act_matmul`` in place of the regimes,
which an older checkout may not have. Needs one card; the card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's calls (K1 phase 7, K2 phase 12), then calls around the regime boundary
SHAPES = [(512, 512, 10), (8192, 4096, 4096), (333, 200, 19), (65536, 1024, 1024),
          (1000, 512, 256), (1000, 1024, 300), (1024, 1024, 1024), (2048, 1024, 1024),
          (4096, 1024, 1024), (512, 4096, 4096), (2048, 4096, 4096)]


def short(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    found = re.search(r"int8_\w+", name)
    return found.group(0) if found else name[:40]


def kernel_times(fn, iters: int) -> dict:
    """Device ms per call of each kernel ``fn()`` launches, by name
    (``torch.profiler``; a trace that lost kernels shows as a short one)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] += e.self_device_time_total / 1e3 / iters
    return dict(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="checkout whose micronet_tpu_torch is timed (public entries only)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_regimes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's, before another tree comes first on the path

    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    from micronet_tpu_torch.ops import _build
    from micronet_tpu_torch.ops import int_matmul as i8

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    print(f"micronet_tpu_torch from {Path(i8.__file__).resolve().parents[2]}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for m, k, n in SHAPES:
        iters = 30 if 2 * m * k * n < 1e10 else 10
        k1 = cs.k1_args(m, k, n, 0.05, 0.0, -128.0, 127.0, dev, gen)
        k2 = cs.k2_args("path", m, k, n, dev, gen)
        line = [f"M={m:6d} K={k:5d} N={n:5d}"]
        if args.tree is None:
            line.append(f"(picks {i8._k1_regime(m, k, n, _build.sm_count(dev))}):")
            for name, call_args, binary in (("K1", k1, False), ("K2", k2, True)):
                for regime, fn in cs.int8_regimes(i8, binary).items():
                    fn.__name__ = f"{name}_{regime}"
                    t = cs.device_ms(fn, [call_args], iters, 1 if regime == "small" else 3)
                    line.append(f"{name} {regime} {t:.4f}")
                    if regime == "gemm":
                        times = kernel_times(lambda: fn(*call_args), iters)
                        line.append("[" + ", ".join(f"{short(kname)} {kt:.4f}"
                                                    for kname, kt in times.items()) + "]")
        else:
            line.append("(public):")
            for name, fn, call_args in (("K1", i8.int8_matmul_dequant, k1),
                                        ("K2", i8.binary_act_matmul, k2)):
                line.append(f"{name} {cs.device_ms(fn, [call_args], iters):.4f}")
        codes = i8.quantize_int8(k1[0], 0.05, 0.0, -128.0, 127.0)
        t = cs.device_ms(torch._int_mm, [cs.int_mm_args(codes, k1[1])], iters)
        line.append(f"torch._int_mm {t:.4f} ms")
        print(" ".join(line), flush=True)
        del k1, k2, codes
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
