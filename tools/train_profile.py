#!/usr/bin/env python3
"""Where a training step's time goes on the card: full-width NIN-GC at
batch 256 for each method of ``chip_smoke.py`` phase 14, a few steps
traced with ``torch.profiler``.

    python3 tools/train_profile.py [--steps 3] [--out DIR]

For each method (IAO and DoReFa twice: under the default ``"auto"``
training lowerings, and pinned to the exact f32 path): 3 untraced steps
(allocations, cuDNN's choices), then ``--steps`` traced ones; prints the
device's busy time (the union of the kernels' intervals) over the traced
wall, the kernels' summed time and the summed time by kernel family (the
largest first), and writes each table under ``--out``. TF32 is off, as in the smoke run. Needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# IAO and DoReFa under the default "auto" (lowered on the card) and pinned
# to the exact f32 path
EXACT = dict(act_codes="off", bn_stats="off")
METHODS = {"float": (None, {}), "iao": ("iao", dict(bn_fuse=True)),
           "iao_exact": ("iao", dict(bn_fuse=True, **EXACT)), "dorefa": ("dorefa", {}),
           "dorefa_exact": ("dorefa", EXACT), "wbwtab": ("wbwtab", dict(W=3, A=2))}


def _group(name: str) -> str:
    """A kernel's family, by its name."""
    n = name.lower()
    if "transpose" in n:
        return "cuDNN layout transposes (NCHW <-> its internal layout)"
    if any(k in n for k in ("conv", "gemm", "wgrad", "dgrad", "xmma", "cudnn", "sm80", "sm90")):
        return "convolutions (forward, data and weight gradients)"
    if "reduce" in n or "norm" in n:
        return "reductions (BN statistics, observers, losses)"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise (fake-quant, BN, ReLU, optimizer, casts)"
    if "index" in n or "gather" in n or "scatter" in n or "cat" in n:
        return "indexing (channel shuffles, batch gathers)"
    return "other: " + name[:60]


def _busy_ms(prof) -> float:
    """The device's busy time: the union of the kernels' intervals (cuDNN
    runs some kernels of a step side by side, so their summed time can
    exceed the wall)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Optimizer.", "ProfilerStep")))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", type=Path, default=Path("build/train_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import TrainConfig, Trainer, data

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    ds = data.load_cifar10()
    for label, (method, kw) in METHODS.items():
        model = Net(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        if method:
            model = prepare(model, QuantConfig(**kw), method=method, device=dev)
        tr = Trainer(train_mode(model), TrainConfig(batch_size=args.batch), dataset=ds,
                     device=dev)
        imgs, labels = tr._device_dataset()[:2]

        def step(i):
            lo = (i * args.batch) % (imgs.shape[0] - args.batch)
            x = data.augment_batch(tr.gen, imgs[lo:lo + args.batch])
            tr.train_step(x, labels[lo:lo + args.batch])

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                step(3 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # the kernels' own rows (no host time); an operator's row would count
        # its kernels again, and so would the optimizer's range annotation
        kernels = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0 and e.self_cpu_time_total == 0
                   and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
        summed = sum(e.self_device_time_total for e in kernels) / 1e3
        busy = _busy_ms(prof)
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
        (args.out / f"train_profile_{label}.txt").write_text(table)
        groups = {}
        for e in kernels:
            g = _group(e.key)
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        launches = sum(e.count for e in kernels)
        print(f"{label}: device busy {busy / args.steps:.2f} ms of {wall / args.steps:.2f} ms a "
              f"step ({100 * busy / wall:.1f} %), kernel time {summed / args.steps:.2f} ms, "
              f"{launches / args.steps:.0f} kernels a step")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {ms / args.steps:8.3f} ms ({100 * ms / summed:4.1f} %)  {g}")
        del tr, model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
