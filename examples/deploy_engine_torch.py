"""Deploy pipeline with the PyTorch/CUDA port: KL-entropy PTQ -> int8
engine -> CUDA-graph batch buckets + a ``torch.export`` artifact.

Run:  python examples/deploy_engine_torch.py [--device cpu] [--out DIR]

The port's counterpart of ``examples/deploy_engine.py``:
1. calibrate a float model with TRT-style KL entropy observers (and write
   the calibration cache),
2. fuse BN and freeze to the chained int8 engine,
3. build batch buckets (``build_engine(profile=(1, 8, 32))``: one CUDA
   graph per bucket on the card, the eager engine on the CPU) and check a
   padded request against the eager engine,
4. serialize a weights-embedded ``torch.export`` artifact and run it back.
Runs on the card unless given ``--device cpu``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="build/deploy_example",
                    help="directory for the calibration cache and the artifact")
    args = ap.parse_args()

    from micronet_tpu_torch._device import resolve_device
    from micronet_tpu_torch.infer import (build_engine, deserialize_engine, freeze_int,
                                          fuse_bn_iao, serialize_engine)
    from micronet_tpu_torch.models import nin
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.calibrate import finalize_entropy_calibration
    from micronet_tpu_torch.quant.config import QuantConfig

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cache = os.path.join(args.out, "calib.json")
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1) KL-entropy calibration (streams the float network)
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True, ptq=True, ptq_observer="kl",
                      pretrained_model=True)
    q = train_mode(prepare(nin.Net(cfg=[16] * 8, device=dev, generator=gen), cfg, device=dev))
    with torch.no_grad():
        for _ in range(8):
            q(torch.randn((16, 32, 32, 3), device=dev, generator=gen))
    table = finalize_entropy_calibration(q, cache=cache)
    print(f"calibrated {len(table)} tensors (cache: {cache})")

    # 2) fuse + freeze
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=dev))
    engine = eval_mode(freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3), device=dev),
                                  device=dev))

    # 3) batch buckets (min/opt/max = 1/8/32)
    compiled = build_engine(engine, profile=(1, 8, 32), device=dev)
    x = torch.randn((5, 32, 32, 3), device=dev, generator=gen)
    with torch.no_grad():
        ref = engine(x)
    got = compiled(x)
    if not torch.equal(got, ref):
        raise SystemExit(f"bucketed engine differs from eager: {(got - ref).abs().max()}")
    print(f"buckets {compiled.buckets}: a batch-5 request equals the eager engine")

    # 4) serialized artifact round trip
    path = os.path.join(args.out, "engine.pt2")
    blob = serialize_engine(engine, batch=8, path=path, platforms=(dev.type,))
    runner = deserialize_engine(path)
    x8 = torch.randn((8, 32, 32, 3), device=dev, generator=gen)
    y = runner(x8)
    with torch.no_grad():
        same = torch.equal(y, engine(x8))
    print(f"artifact: {len(blob)} bytes, output {tuple(y.shape)}, equal to the engine: {same}"
          " - deploy OK")
    if not same:
        raise SystemExit("the artifact differs from the engine")


if __name__ == "__main__":
    main()
