"""End-to-end QAT -> BN-fuse -> int8 engine on CIFAR-10 (or the synthetic
stand-in when the dataset is not on disk) with the PyTorch/CUDA port.

Run:  python examples/qat_cifar10_torch.py [--epochs 30] [--device cpu]
      torchrun --nproc_per_node 4 examples/qat_cifar10_torch.py --dp 4

The port's counterpart of ``examples/qat_cifar10.py``: IAO W8A8 QAT with
in-training BN fusion on NIN-GC, best-accuracy checkpoints, paired
train/inference equivalence, and the integer engine export. Runs on the
card unless given ``--device cpu``. ``--dp N`` trains data-parallel over N
processes, one a card, started by ``torchrun --nproc_per_node N`` (with
``--device cpu`` over gloo): each rank takes its rows of every global
batch of ``--batch`` images, the observers and BN statistics are global,
the gradients averaged; rank 0 writes the checkpoints and runs the
equivalence check and the export.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel processes (start them with torchrun)")
    ap.add_argument("--save", default="models_save/nin_gc_w8a8.npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from micronet_tpu_torch._device import resolve_device
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao, paired_equivalence_eval
    from micronet_tpu_torch.models import nin_gc
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.parallel import initialize, make_mesh
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import TrainConfig, Trainer, save_state

    mesh = None
    if args.dp > 1:
        if not initialize(device=args.device):
            raise SystemExit("--dp > 1 runs one process a rank: start it with torchrun "
                             f"--nproc_per_node {args.dp}")
        mesh = make_mesh(args.dp, 1, device=args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)
    gen = torch.Generator(device=dev).manual_seed(1)  # the same weights on every rank
    model = train_mode(prepare(nin_gc.Net(device=dev, generator=gen), cfg, inplace=True,
                               device=dev))
    trainer = Trainer(model, TrainConfig(lr=1e-3, batch_size=args.batch, epochs=args.epochs),
                      mesh=mesh, device=dev)
    if trainer.data.source == "synthetic" and trainer.writer:
        print("NOTE: CIFAR-10 not found (set CIFAR10_DIR); using synthetic data")
    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    best = trainer.fit(checkpoint_path=args.save)
    if not trainer.writer:
        return
    print(f"best acc {best * 100:.2f}%")

    fused = fuse_bn_iao(model, cfg, device=dev)
    acc_t, acc_i, fps_t, fps_i = paired_equivalence_eval(
        model, fused, trainer.data.test_images, trainer.data.test_labels)
    print(f"FPS: train {fps_t:.1f} inference {fps_i:.1f}")
    if abs(acc_t - acc_i) >= 0.005:
        raise SystemExit("train/inference equivalence violated")

    engine = freeze_int(eval_mode(fused), device=dev)
    save_state(args.save.replace(".npz", "_int8.npz"), engine)
    print("int8 engine exported")


if __name__ == "__main__":
    main()
