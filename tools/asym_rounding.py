#!/usr/bin/env python3
"""Where the asymmetric engine's distance from its fake-quant model comes
from, for the W4A4 first/last-8 recipe (``q_type=1``) on full-width
ResNet-18 and NIN-GC.

    python3 tools/asym_rounding.py [--device cpu] [--batch 8] [--seed 0]

Each model gets seeded random weights, ``prepare`` with BN folding, 4
calibration forwards at batch 64, ``fuse_bn_iao`` and ``freeze_int``.
Then, on ``--batch`` images, one JSON line per model:

- ``jax_order``: the engine as it is (the zero-point terms added to the
  f32 accumulator in the JAX package's order) against the fake-quant
  model: the logits' max |difference| and, each layer fed its fake-quant
  layer's input, the largest layer difference relative to that layer's
  max |output|;
- ``exact``: the same with every asymmetric accumulator replaced by its
  exact integer value cast once to f32 (``engine.exact_zero_point_acc``),
  which isolates the f32 rounding of the correction terms from the code
  flips that f32 sums in another order cause anyway.

The device is CUDA unless ``--device cpu``; on the card the first line is
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RECIPE = dict(a_bits=4, w_bits=4, q_type=1, bn_fuse=True, first_layer_a_bits=8,
              first_layer_w_bits=8, last_layer_a_bits=8, last_layer_w_bits=8)


@torch.no_grad()
def _layer_gaps(engine, fused, x):
    """Per engine conv and linear, fed its fake-quant layer's input: the
    max |difference| from that layer's output over its max |output|."""
    from micronet_tpu_torch.infer import engine as te

    names = [n for n, m in engine.named_modules()
             if isinstance(m, (te.IntConv2d, te.IntLinear))]
    seen = {}

    def keep(n):
        def hook(module, args, out):
            seen[n] = (args[0], out)
        return hook

    hooks = [fused.get_submodule(n).register_forward_hook(keep(n)) for n in names]
    fused(x)
    for h in hooks:
        h.remove()
    gaps = {}
    for n in names:
        inp, ref = seen[n]
        gaps[n] = ((engine.get_submodule(n)(inp) - ref).abs().max() / ref.abs().max()).item()
    return gaps


def _exact(engine):
    """Every asymmetric conv's accumulator as its exact integer value, one
    f32 cast."""
    from micronet_tpu_torch.infer import engine as te

    for m in engine.modules():
        if isinstance(m, te.IntConv2d) and not (m.symmetric and m.w_symmetric):
            m._zero_point_acc = (lambda x_q, layer=m: te.exact_zero_point_acc(layer, x_q)[0]
                                 .to(torch.float32).to(x_q.device))


@torch.no_grad()
def measure(name, build, dev, batch, seed):
    import copy

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    cfg = QuantConfig(**RECIPE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = train_mode(prepare(build(device=dev, generator=gen), cfg, device=dev))
    for _ in range(4):
        q(torch.randn((64, 32, 32, 3), device=dev, generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=dev))
    x = torch.randn((batch, 32, 32, 3), device=dev, generator=gen)
    engine = eval_mode(freeze_int(fused, example_input=x[:1], device=dev))
    ref = fused(x)
    row = {"model": name, "batch": batch}
    for label in ("jax_order", "exact"):
        if label == "exact":
            engine = copy.deepcopy(engine)
            _exact(engine)
        out = engine(x)
        gaps = _layer_gaps(engine, fused, x)
        worst = max(gaps, key=gaps.get)
        row[label] = dict(logits_max_abs=(out - ref).abs().max().item(),
                          top1_agree=(out.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                          worst_layer=worst, worst_layer_rel=gaps[worst])
    row["fake_quant_max_abs_logit"] = ref.abs().max().item()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from micronet_tpu_torch.models import nin_gc
    from micronet_tpu_torch.models.resnet import resnet18

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"], capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip())
    for name, build in (("resnet18", resnet18), ("nin_gc", nin_gc.Net)):
        print(json.dumps(measure(name, build, dev, args.batch, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
