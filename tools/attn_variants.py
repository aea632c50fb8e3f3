#!/usr/bin/env python3
"""Decode attention's cluster regime at the serving shapes, by device time,
in diagnostic builds of its kernel.

    python3 tools/attn_variants.py [--builds "" MN_ATTN_NO_MATH ...]
    python3 tools/attn_variants.py --tree DIR
    python3 tools/attn_variants.py --timeline

The cases are ``chip_smoke.attention_cases``: K4a at phase 3's shape
(64 groups, R = 4, D = 128, S = 2,048, bounds 1..2,048) and at the serving
loop's fills (bounds 16..288), K4b at phase 10's (S = 8,192, bounds
0..8,192), K6 over pages of 16 shuffled in the pool at phase 10's shape,
and the dense kernel over K6's gathered view; random codes and scales from
a seeded generator, copies larger than L2 together.

For each build (a set of macros of ``csrc/decode_attention.cuh``, such as
the diagnostic ``MN_ATTN_NO_MATH``; all builds started together), each case
prints the device time per call (``torch.profiler``, through
``chip_smoke.device_ms``), the time of back-to-back calls (CUDA events) and
how many clusters the card holds at once. ``--tree DIR`` imports
``micronet_tpu_torch`` from another checkout (an older commit unpacked with
``git archive``) and times its public wrappers instead. ``--timeline`` builds the dense
kernel with ``MN_ATTN_TIMELINE`` and prints, for one call of each dense
case, when its blocks start and end (``%globaltimer``) and how many SM
cycles (``clock64``) each block spends in each phase, median and largest
over the blocks. Needs one card; the card's name and power limit come
first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


PHASES = ("prologue and q", "K loop", "max exchange", "softmax", "V loop", "partials sent",
          "partials wait", "outputs")


def timeline(cases, da, _build) -> None:
    import ctypes
    import statistics

    defines = ("MN_ATTN_TIMELINE",)
    load = _build.load
    _build.load = lambda name, sig, extra=(): load(name, sig, tuple(extra) + defines)
    try:
        lib = load("decode_attention",
                   {**da._LIB_SIGNATURES, "mn_attn_timeline": [ctypes.c_void_p, ctypes.c_int]},
                   defines)
        for name, fn, calls, s in cases:
            if not name.startswith("K4"):
                continue
            g = calls[0][0].shape[0]
            blocks = g * da._plan(s)[0]
            fn(*calls[0])
            torch.cuda.synchronize()
            fn(*calls[1 % len(calls)])
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (blocks * 12))()
            _build.check(lib.mn_attn_timeline(ctypes.addressof(buf), blocks * 12), "timeline")
            st = [list(buf[b * 12:(b + 1) * 12]) for b in range(blocks)]
            t0 = min(b[0] for b in st)
            starts = sorted((b[0] - t0) / 1e3 for b in st)
            ends = sorted((b[11] - t0) / 1e3 for b in st)
            print(f"{name}: {blocks} blocks; starts {starts[0]:.2f}..{starts[-1]:.2f} us "
                  f"(median {statistics.median(starts):.2f}), ends {ends[0]:.2f}.."
                  f"{ends[-1]:.2f} us (median {statistics.median(ends):.2f})")
            lives = [(b[11] - b[0]) / 1e3 for b in st]
            print(f"  block lifetime: median {statistics.median(lives):.2f} us, "
                  f"largest {max(lives):.2f} us")
            for k, phase in enumerate(PHASES):
                cyc = [b[k + 2] - b[k + 1] for b in st]
                print(f"  {phase}: median {statistics.median(cyc):.0f} cycles, "
                      f"largest {max(cyc)}")
            cyc = [b[9] - b[1] for b in st]
            print(f"  whole block (clock64): median {statistics.median(cyc):.0f}, "
                  f"largest {max(cyc)} cycles", flush=True)
    finally:
        _build.load = load


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--builds", nargs="*", default=[""],
                    help="macro sets, each comma-separated (\"\" is the kernel as it is)")
    ap.add_argument("--tree", type=Path, default=None,
                    help="checkout whose micronet_tpu_torch is timed (public wrappers only)")
    ap.add_argument("--timeline", action="store_true",
                    help="per-phase cycles of each block, from a stamping build")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's, before another tree comes first on the path

    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    from micronet_tpu_torch.ops import _build
    from micronet_tpu_torch.ops import decode_attention as da

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    print(f"micronet_tpu_torch from {Path(da.__file__).resolve().parents[2]}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = list(cs.attention_cases(dev, gen))
    if args.tree is not None:
        for name, fn, calls, s in cases:
            per_call = 1 if s <= da._MAX_RESIDENT_S else 3  # the split regime's three kernels
            try:
                dev_t = f"{cs.device_ms(fn, calls, 30, per_call):.4f} ms"
            except SystemExit:  # every trace lost kernels
                dev_t = "not measured"
            print(f"{name}: device {dev_t}, events {cs.time_ms(fn, calls, 50):.4f} ms",
                  flush=True)
        return 0

    if args.timeline:
        timeline(cases, da, _build)
        return 0
    builds = [tuple(m for m in b.split(",") if m) for b in args.builds]
    started = [(src, defines, _build._start(src, defines))
               for defines in builds for src in ("decode_attention", "paged_attention")]
    for src, _, (st, out) in started:
        if st is not None:
            _build._finish(src, st, out)
    load = _build.load
    try:
        for defines in builds:
            _build.load = lambda name, sig, extra=(), _d=defines: load(name, sig,
                                                                        tuple(extra) + _d)
            for name, fn, calls, s in cases:
                t = cs.device_ms(fn, calls, 30, 1)
                ev = cs.time_ms(fn, calls, 50)
                print(f"[{' '.join(defines) or 'kernel'}] {name}: device {t:.4f} ms, events "
                      f"{ev:.4f} ms, {da.cluster_occupancy(cs.ATT_R, s)} clusters at once",
                      flush=True)
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
