#!/usr/bin/env python3
"""K3's two regimes side by side on one card, by device time, around the
boundary that ``ops/int4_matmul.py::_k3_regime`` draws at 128 batch rows.

    python3 tools/k3_regimes.py [--ms 64,128,129,192,256,384,512]
    python3 tools/k3_regimes.py --tree DIR [--ms 6000]

At each M, for each of the five Llama-3-8B shapes of ``chip_smoke.py``
phase 3 (group 128, weights cold in L2 as there), the device time per call
(``torch.profiler``, through ``chip_smoke.device_ms``) of regime A (the w4
kernel's hl8 mode) and of regime B (the wgmma GEMM with its x pre-pass),
each forced whatever M is, beside ``torch.matmul`` on the dequantized bf16
weight; then the 129 calls of one forward at that M.

``--tree DIR`` imports ``micronet_tpu_torch`` from another checkout (an
older commit unpacked with ``git archive``) and times its public
``int4_matmul_grouped_hl8`` in place of the two regimes, which an older
checkout may not have. Needs one card; the card's name and power limit come
first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ms", default=None,
                    help="comma-separated batch rows (default 64,...,512; 6000 with --tree)")
    ap.add_argument("--tree", type=Path, default=None,
                    help="checkout whose micronet_tpu_torch is timed (public entry only)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_regimes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's, before another tree comes first on the path

    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    from micronet_tpu_torch.ops import int4_matmul as im

    ms = [int(v) for v in (args.ms or ("6000" if args.tree else "64,128,129,192,256,384,512"))
          .split(",")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    print(f"micronet_tpu_torch from {Path(im.__file__).resolve().parents[2]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    g = cs.GROUP
    if args.tree is None:
        kernels = {
            "A": (lambda x, p, s: im._plain_call("mn_int4_matmul_grouped_hl8", x, p, s, g), 1),
            "B": (lambda x, p, s: im._gemm_call(x, p, s, g), 2),  # the x pre-pass, the GEMM
        }
    else:
        kernels = {"public": (im.int4_matmul_grouped_hl8, 1)}
    per_step = {}
    times = {}  # (label, m) -> ms of one forward's 129 calls
    for (k, n), steps in cs.K3_SHAPES:
        per_step[k, n] = steps
        weights, w_bf16 = cs._k3_weights(k, n, dev, gen)
        for m in ms:
            x = torch.randn((m, k), device=dev, generator=gen)
            calls, lib_calls, iters = cs._k3_calls(m, x, weights, w_bf16)
            line = [f"M={m:5d} K={k:6d} N={n:6d}:"]
            for label, (fn, per_call) in list(kernels.items()) + [("torch.matmul",
                                                                   (torch.matmul, 1))]:
                t = cs.device_ms(fn, lib_calls if fn is torch.matmul else calls, iters, per_call)
                times[label, m] = times.get((label, m), 0.0) + t * steps
                line.append(f"{label} {t:.4f}")
            print(" ".join(line) + " ms", flush=True)
            del x, calls, lib_calls
        del weights, w_bf16
        torch.cuda.empty_cache()
    print(f"one forward's {sum(per_step.values())} calls, device ms:")
    for m in ms:
        print(f"M={m:5d}: " + ", ".join(f"{label} {times[label, m]:.3f}"
                                          for label in list(kernels) + ["torch.matmul"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
