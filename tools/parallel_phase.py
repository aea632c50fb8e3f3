#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 21 (data and tensor parallelism) alone, on
every card of the machine: builds the kernels, makes phase 9's ResNet-18
W8A8 engine, saves it for the ranks (as phase 19 does) and runs the
phase, printing its lines and writing ``<out>/parallel.json``.

    python3 tools/parallel_phase.py [--seed N] [--profile] [--out DIR]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path, default=Path("build/parallel_phase"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device", file=sys.stderr)
        return 2
    from micronet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_name()
    cs.log(card)
    _build.build_all()
    report, keep = {}, {}
    cs.resnet_engine(dev, args.seed, report, keep=keep)
    shared = cs.keep_parallel_engine(keep["engine"], dev, args.seed, args.out)
    del keep
    torch.cuda.empty_cache()
    k1 = cs.parallel(dev, args.seed, shared, card, report, args.profile)
    report["k1_launches_phase21"] = k1
    report["seconds"] = time.perf_counter() - t0
    (args.out / "parallel.json").write_text(json.dumps(report, indent=1))
    cs.log(f"parallel_phase: K1 launches {k1}; {report['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
