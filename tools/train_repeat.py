#!/usr/bin/env python3
"""Whether same-seed training repeats on the card, and what it costs:
``chip_smoke.py`` phase 14's ``cli train`` runs (full-width NIN-GC, batch
256, 2 epochs on the synthetic set, for each method) twice with the same
``--seed``, then phase 15's NIN ``train -sr`` and ``prune`` twice.

    python3 tools/train_repeat.py [--tree DIR] [--methods float,iao,dorefa,wbwtab]

For each method, one JSON line: both runs' img/s (the run's first step
left out, as phase 14 reads it), their step ms medians, and how many
checkpoint arrays differ between them (with the largest differences);
then one for the pruning pipeline: both pruned widths and the arrays in
which the two ``-sr`` checkpoints differ. ``--tree DIR`` runs another
checkout's ``micronet_tpu_torch`` (an older commit unpacked with ``git
archive``), so that the trees before and after a change run in one call.
Needs one card; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="checkout whose micronet_tpu_torch runs (default: this one)")
    ap.add_argument("--methods", default="float,iao,dorefa,wbwtab")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=Path("build/train_repeat"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's, before another tree comes first on the path

    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    from micronet_tpu_torch import cli

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    tree = str(Path(cli.__file__).resolve().parents[1])
    print(card)
    print(f"micronet_tpu_torch from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = args.out
    out.mkdir(parents=True, exist_ok=True)

    def differing(a, b):
        diff = cs.checkpoint_diff(a, b)
        return len(diff), dict(sorted(diff.items(), key=lambda kv: -kv[1])[:3])

    methods = dict(cs.TRAIN_METHODS)
    for label in args.methods.split(","):
        runs = []
        for i in range(2):
            ck, metrics = out / f"{label}_{i}.npz", out / f"{label}_{i}.jsonl"
            metrics.unlink(missing_ok=True)
            cs._cli(["train", "--device", str(dev), *methods[label], "--epochs", cs.TRAIN_EPOCHS,
                     "--train_batch_size", cs.TRAIN_BATCH, "--seed", args.seed, "--save", ck,
                     "--metrics", metrics], f"train {label}")
            runs.append(cs._train_numbers(metrics, cs.TRAIN_BATCH))
        n, worst = differing(out / f"{label}_0.npz", out / f"{label}_1.npz")
        print(json.dumps({"tool": "train_repeat", "card": card, "tree": tree, "method": label,
                          "batch": cs.TRAIN_BATCH, "img_s": [r["img_s"] for r in runs],
                          "step_ms_median": [r["step_ms_median"] for r in runs],
                          "arrays_differing": n, "largest_differences": worst}))
    cfgs = []
    for i in range(2):
        sr, pruned = out / f"nin_sr_{i}.npz", out / f"nin_pruned_{i}.npz"
        cs._cli(["train", "--device", str(dev), "--method", "float", "-sr", "--s", "1e-4",
                 "--model_type", 0, "--epochs", cs.NIN_PRUNE_EPOCHS, "--seed", args.seed,
                 "--train_batch_size", cs.TRAIN_BATCH, "--save", sr], "train -sr nin")
        text, _ = cs._cli(["prune", "--device", str(dev), "--model_type", 0, "--model", sr,
                           "--save", pruned, "--percent", 0.5, "--normal_regular", 1],
                          "prune nin")
        cfgs.append(json.loads(text.split("cfg: ")[1].splitlines()[0]))
    n, worst = differing(out / "nin_sr_0.npz", out / "nin_sr_1.npz")
    print(json.dumps({"tool": "train_repeat", "card": card, "tree": tree,
                      "pipeline": "nin -sr -> prune", "cfgs": cfgs, "same_cfg": cfgs[0] == cfgs[1],
                      "sr_arrays_differing": n, "largest_differences": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
