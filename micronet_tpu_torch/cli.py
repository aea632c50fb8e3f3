"""The command line of the port: the counterpart of
``micronet_tpu/cli.py``, with its subcommands and flags, run as
``python -m micronet_tpu_torch.cli``:

=============  ==========================================================
subcommand     what it does
=============  ==========================================================
train          QAT (``--method iao|dorefa|wbwtab``), float training
               (``--method float``, ``-sr`` for BN sparsity), PTQ
               (``--ptq``, ``--ptq_observer percentile|kl``,
               ``--calib_cache``), QAFT and the pruned-model handoffs
prune          BN-gamma channel pruning (``--normal_regular N``, ``--gc``)
bn-fuse        the BN-fused inference model (``--dump`` adds text dumps)
model-test     paired train/inference equivalence on the test set
freeze-int     the integer engine (its ``IntLinear`` layers run K1)
deploy         the engine as a ``torch.export`` artifact (``.pt2``)
=============  ==========================================================

Every subcommand takes ``--device``: CUDA by default, which raises
without a card; ``--device cpu`` runs the plain PyTorch path. The
checkpoints are the JAX package's format (``train/checkpoint.py``), so a
checkpoint of either CLI feeds the other's next stage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["main"]


def _build_model(model_type: int, cfg, dev, gen):
    from .models import nin, nin_gc
    from .models.resnet import resnet18

    if model_type == 0:
        return nin.Net(cfg=cfg, device=dev, generator=gen)
    if model_type == 1:
        return nin_gc.Net(cfg=cfg, device=dev, generator=gen)
    return resnet18(device=dev, generator=gen)


def _parse_cfg(s):
    return [int(v) for v in s.split(",")] if s else None


def _header(path) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["__header__"]).decode())


def _ckpt_cfg(path, default=None):
    """The channel widths a checkpoint's header stores (a pruned model's
    ``cfg``), so later stages rebuild the pruned architecture."""
    try:
        return _header(path).get("extra", {}).get("cfg", default)
    except (OSError, KeyError, ValueError):
        return default


def _model_cfg(args):
    cfg = _parse_cfg(args.cfg)
    if cfg is None and getattr(args, "model", ""):
        cfg = _ckpt_cfg(args.model)
    return cfg


def _quant_config(args):
    from .quant.config import QuantConfig

    return QuantConfig(
        a_bits=args.a_bits, w_bits=args.w_bits, q_type=args.q_type, q_level=args.q_level,
        weight_observer=args.weight_observer, bn_fuse=args.bn_fuse,
        bn_fuse_calib=args.bn_fuse_calib, pretrained_model=args.pretrained_model,
        qaft=args.qaft, ptq=args.ptq, percentile=args.percentile,
        ptq_observer=args.ptq_observer, first_layer_a_bits=args.first_layer_a_bits,
        first_layer_w_bits=args.first_layer_w_bits, last_layer_a_bits=args.last_layer_a_bits,
        last_layer_w_bits=args.last_layer_w_bits, W=args.W, A=args.A)


def _setup(args):
    """(device, generator seeded with 0): the model's initial weights are
    overwritten by a checkpoint in every subcommand but ``train``."""
    dev = resolve_device(args.device)
    return dev, torch.Generator(device=dev).manual_seed(0)


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which raises without a card; "
                        "'cpu' runs the plain PyTorch path)")


def _add_quant_flags(p: argparse.ArgumentParser):
    _add_common_flags(p)
    p.add_argument("--a_bits", type=int, default=8)
    p.add_argument("--w_bits", type=int, default=8)
    p.add_argument("--q_type", type=int, default=0, help="0 sym, 1 asym")
    p.add_argument("--q_level", type=int, default=0, help="0 per-ch, 1 per-layer")
    p.add_argument("--weight_observer", type=int, default=0, help="0 minmax, 1 ema")
    p.add_argument("--bn_fuse", action="store_true")
    p.add_argument("--bn_fuse_calib", action="store_true")
    p.add_argument("--pretrained_model", action="store_true")
    p.add_argument("--qaft", action="store_true")
    p.add_argument("--ptq", action="store_true")
    p.add_argument("--ptq_control", action="store_true", help="cap PTQ at 2 epochs")
    p.add_argument("--ptq_batch", type=int, default=200)
    p.add_argument("--percentile", type=float, default=0.9999)
    p.add_argument("--first_layer_a_bits", type=int, default=0)
    p.add_argument("--first_layer_w_bits", type=int, default=0)
    p.add_argument("--last_layer_a_bits", type=int, default=0)
    p.add_argument("--last_layer_w_bits", type=int, default=0)
    p.add_argument("--ptq_observer", choices=["percentile", "kl"], default="percentile",
                   help="PTQ calibrator: percentile histogram or KL entropy calibration")
    p.add_argument("--calib_cache", default=None,
                   help="KL calibration table file: read if present, written otherwise")
    p.add_argument("--W", type=int, default=2, help="wbwtab: 2 bin, 3 ter, 32 fp")
    p.add_argument("--A", type=int, default=2, help="wbwtab: 2 bin, 32 fp")
    p.add_argument("--two_stage", type=int, default=0, metavar="EPOCHS",
                   help="wbwtab with A=2 only: train EPOCHS with float activations first, "
                        "then binarize them and run the main schedule")


def cmd_train(args) -> int:
    from .nn import prepare, qat_wbwtab, train_mode
    from .train import TrainConfig, Trainer, load_state, scaled_milestones

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model_cfg = _parse_cfg(args.cfg)
    if args.prune_quant:
        # a pruned float checkpoint: rebuild its architecture, load, quantize
        model_cfg = _ckpt_cfg(args.prune_quant, model_cfg)
        model = _build_model(args.model_type, model_cfg, dev, gen)
        load_state(args.prune_quant, model)
    elif args.prune_qaft:
        # a pruned quant checkpoint: its state loads after prepare()
        model_cfg = _ckpt_cfg(args.prune_qaft, model_cfg)
        model = _build_model(args.model_type, model_cfg, dev, gen)
    else:
        model = _build_model(args.model_type, model_cfg, dev, gen)
    if args.refine:
        load_state(args.refine, model)  # float warm start before quantizing

    cfg = _quant_config(args)
    qmodel = model if args.method == "float" else prepare(model, cfg, method=args.method,
                                                          inplace=True, device=dev)
    if args.prune_qaft:
        load_state(args.prune_qaft, qmodel)
    train_mode(qmodel)

    if args.auto_resume and not args.resume:
        # prefer the newer of <save>.latest.npz and <save>; resolved before
        # the two-stage block, so a restarted run does not repeat stage 1
        def step_of(p):
            try:
                return _header(p)["step"]
            except (OSError, KeyError, ValueError):
                return -1

        cands = [p for p in (args.save + ".latest.npz", args.save) if os.path.exists(p)]
        if cands:
            args.resume = max(cands, key=step_of)

    if args.method == "wbwtab" and args.A == 2 and args.two_stage > 0 and not args.resume:
        # stage 1 of the two-stage recipe: the same net with float activations
        acts = [m for m in qmodel.modules() if isinstance(m, qat_wbwtab.ActivationQuantizer)]
        for m in acts:
            m.A = 32
        stage_cfg = TrainConfig(lr=args.lr, weight_decay=args.wd,
                                batch_size=args.train_batch_size, epochs=args.two_stage,
                                seed=args.seed, milestones=scaled_milestones(args.two_stage),
                                metrics_path=args.metrics or None, grad_accum=args.grad_accum)
        s1 = Trainer(qmodel, stage_cfg, device=dev).fit()
        print(f"two-stage: stage-1 (float A) best acc {s1 * 100:.2f}%")
        for m in acts:
            m.A = 2

    tcfg = TrainConfig(lr=args.lr, weight_decay=args.wd, batch_size=args.train_batch_size,
                       epochs=args.epochs, seed=args.seed, ptq=args.ptq,
                       ptq_batch=args.ptq_batch, ptq_control=args.ptq_control,
                       calib_cache=args.calib_cache, metrics_path=args.metrics or None,
                       async_checkpoint=args.async_checkpoint, keep_latest=args.auto_resume,
                       grad_accum=args.grad_accum)
    trainer = Trainer(qmodel, tcfg, device=dev)
    if args.resume:
        step, best, _ = load_state(args.resume, qmodel, optimizer=trainer.optimizer)
        trainer.epoch, trainer.best_acc = step + 1, best
        print(f"resumed from {args.resume} at epoch {step} (best {best:.4f})")
    if trainer.data.source == "synthetic":
        print("WARNING: CIFAR-10 not found on disk; training on the synthetic stand-in "
              "(set CIFAR10_DIR)", file=sys.stderr)
    if args.sr:
        # sparsity training: s * sign(gamma) on every BN weight's gradient
        from .prune import bn_l1_grad_update

        trainer.grad_hook = lambda m: bn_l1_grad_update(m, args.s)
    best = trainer.fit(checkpoint_path=args.save,
                       checkpoint_extra={"cfg": model_cfg} if model_cfg else None)
    print(f"best acc: {best * 100:.2f}%")
    return 0


def cmd_prune(args) -> int:
    from .models import nin, nin_gc
    from .nn import eval_mode
    from .prune import compute_prune_masks, prune_model
    from .train import load_state, save_state

    dev, gen = _setup(args)
    ctor = nin.Net if args.model_type == 0 else nin_gc.Net
    model = ctor(cfg=_parse_cfg(args.cfg), device=dev, generator=gen)
    if args.model:
        load_state(args.model, model)
    eval_mode(model)
    layers = 9
    cfg, masks, ratio = compute_prune_masks(model, args.percent,
                                            base_number=args.normal_regular, gc=args.gc,
                                            layers=layers)
    print(f"pruned_ratio: {ratio:.4f}")
    print(f"cfg: {cfg}")
    if args.gc:
        return 0  # grouped-conv mode prints cfg only: retrain at these widths
    new = ctor(cfg=cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    new = prune_model(model, new, masks, layers=layers)
    save_state(args.save, new, extra={"cfg": cfg})
    print(f"saved pruned model to {args.save}")
    return 0


def _quant_model(args, method):
    """The prepared model of a checkpoint (``--model``), on ``--device``."""
    from .nn import prepare
    from .train import load_state

    dev, gen = _setup(args)
    cfg = _quant_config(args)
    q = prepare(_build_model(args.model_type, _model_cfg(args), dev, gen), cfg, method=method,
                inplace=True, device=dev)
    if args.model:
        load_state(args.model, q)
    return q, cfg, dev


def cmd_bn_fuse(args) -> int:
    from .infer import fuse_bn_iao, fuse_bn_wbwtab
    from .train import save_state

    q, cfg, dev = _quant_model(args, args.method)
    fused = (fuse_bn_iao if args.method == "iao" else fuse_bn_wbwtab)(q, cfg, device=dev)
    save_state(args.save, fused)
    print(f"saved bn-fused inference model to {args.save}")
    if args.dump:
        from .infer.dump import dump_model_txt, dump_params_json

        base = args.save.rsplit(".", 1)[0]
        dump_model_txt(base + ".txt", fused)
        dump_params_json(base + "_para.json", fused)
        print(f"dumped parameters to {base}.txt / {base}_para.json")
    return 0


def cmd_model_test(args) -> int:
    from .infer import (fuse_bn_iao, fuse_bn_wbwtab, paired_equivalence_eval,
                        pre_quantize_weights)
    from .nn import train_mode
    from .nn.transform import _copy_model
    from .train import data as data_lib

    q, cfg, dev = _quant_model(args, args.method)
    train_mode(q)
    if args.method == "dorefa":
        # the same checkpoint in a quant_inference copy, weights pre-quantized
        fused = _copy_model(q)
        for m in fused.modules():
            if hasattr(m, "quant_inference"):
                m.quant_inference = True
        pre_quantize_weights(fused)
    else:
        fused = (fuse_bn_iao if args.method == "iao" else fuse_bn_wbwtab)(q, cfg, device=dev)
    ds = data_lib.load_cifar10()
    acc_t, acc_i, fps_t, fps_i = paired_equivalence_eval(q, fused, ds.test_images,
                                                         ds.test_labels, args.eval_batch_size)
    print(f"FPS: train {fps_t:.1f} inference {fps_i:.1f} (x{fps_i / max(fps_t, 1e-9):.2f})")
    ok = abs(acc_t - acc_i) < 0.005
    print("EQUIVALENCE", "OK" if ok else "MISMATCH")
    return 0 if ok else 1


def cmd_freeze_int(args) -> int:
    from .infer import freeze_int, fuse_bn_iao
    from .nn import eval_mode
    from .train import save_state

    q, cfg, dev = _quant_model(args, "iao")
    fused = eval_mode(fuse_bn_iao(q, cfg, device=dev))
    # an example input lets the dataflow planner chain residual graphs
    engine = freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3), device=dev),
                        device=dev)
    save_state(args.save, engine)
    print(f"saved int8 engine (weights int8 + scale/zero_point) to {args.save}")
    return 0


def cmd_deploy(args) -> int:
    """Serialize a deployable engine artifact (the reference's eval_trt.py
    flow: checkpoint -> fused -> int engine -> a ``torch.export`` program
    with the weights embedded)."""
    from .infer import freeze_int, fuse_bn_iao, serialize_engine
    from .nn import eval_mode

    q, cfg, dev = _quant_model(args, "iao")
    fused = eval_mode(fuse_bn_iao(q, cfg, device=dev))
    engine = freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3), device=dev),
                        device=dev)
    platforms = (args.platforms or dev.type,)
    os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
    data = serialize_engine(engine, batch=args.batch, path=args.save, platforms=platforms)
    print(f"serialized engine ({len(data)} bytes, batch {args.batch}, "
          f"platforms {platforms}) -> {args.save}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="micronet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="QAT/PTQ/QAFT/float training")
    pt.add_argument("--method", choices=["iao", "dorefa", "wbwtab", "float"], default="iao")
    pt.add_argument("--model_type", type=int, default=1, help="0 nin, 1 nin_gc, 2 resnet18")
    pt.add_argument("--cfg", default="", help="comma list of channel widths (pruned models)")
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--wd", type=float, default=1e-7)
    pt.add_argument("--train_batch_size", type=int, default=256)
    pt.add_argument("--epochs", type=int, default=300)
    pt.add_argument("--seed", type=int, default=1)
    pt.add_argument("--resume", default="", help="resume a quant checkpoint")
    pt.add_argument("--refine", default="", help="float checkpoint to warm-start from")
    pt.add_argument("--prune_quant", default="",
                    help="pruned {cfg,state} FLOAT checkpoint to quantize")
    pt.add_argument("--prune_qaft", default="",
                    help="pruned QUANT checkpoint to finetune with --qaft")
    pt.add_argument("--save", default="models_save/model.npz")
    pt.add_argument("-sr", dest="sr", action="store_true", help="sparsity train")
    pt.add_argument("--metrics", default="", help="JSONL metrics file (epoch/eval rows)")
    pt.add_argument("--grad_accum", type=int, default=1,
                    help="microbatches per optimizer step (memory-limited training)")
    pt.add_argument("--async_checkpoint", action="store_true",
                    help="write checkpoints on a background thread")
    pt.add_argument("--auto_resume", action="store_true",
                    help="resume from --save (or its .latest sibling, whichever is newer) "
                         "if present; also writes <save>.latest.npz every epoch")
    pt.add_argument("--s", type=float, default=1e-4, help="BN L1 lambda")
    _add_quant_flags(pt)
    pt.set_defaults(fn=cmd_train)

    pp = sub.add_parser("prune", help="BN-gamma channel pruning")
    pp.add_argument("--model_type", type=int, default=0)
    pp.add_argument("--cfg", default="")
    pp.add_argument("--model", default="")
    pp.add_argument("--save", default="models_save/pruned.npz")
    pp.add_argument("--percent", type=float, default=0.5)
    pp.add_argument("--normal_regular", type=int, default=1)
    pp.add_argument("--gc", action="store_true", help="grouped-conv mode")
    _add_common_flags(pp)
    pp.set_defaults(fn=cmd_prune)

    pb = sub.add_parser("bn-fuse", help="export BN-fused inference model")
    pb.add_argument("--method", choices=["iao", "wbwtab"], default="iao")
    pb.add_argument("--model_type", type=int, default=1)
    pb.add_argument("--cfg", default="")
    pb.add_argument("--model", default="")
    pb.add_argument("--save", default="models_save/bn_fused.npz")
    pb.add_argument("--dump", action="store_true",
                    help="also write human-readable .txt + .json parameter dumps")
    _add_quant_flags(pb)
    pb.set_defaults(fn=cmd_bn_fuse)

    pm = sub.add_parser("model-test", help="paired train/inference equivalence eval")
    pm.add_argument("--method", choices=["iao", "wbwtab", "dorefa"], default="iao")
    pm.add_argument("--model_type", type=int, default=1)
    pm.add_argument("--cfg", default="")
    pm.add_argument("--model", default="")
    pm.add_argument("--eval_batch_size", type=int, default=256)
    _add_quant_flags(pm)
    pm.set_defaults(fn=cmd_model_test)

    pf = sub.add_parser("freeze-int", help="export the int8 engine")
    pf.add_argument("--model_type", type=int, default=1)
    pf.add_argument("--cfg", default="")
    pf.add_argument("--model", default="")
    pf.add_argument("--save", default="models_save/int8_engine.npz")
    _add_quant_flags(pf)
    pf.set_defaults(fn=cmd_freeze_int)

    pd = sub.add_parser("deploy", help="serialize the int8 engine as a torch.export artifact")
    pd.add_argument("--model_type", type=int, default=1)
    pd.add_argument("--cfg", default="")
    pd.add_argument("--model", default="")
    pd.add_argument("--save", default="models_save/engine.pt2")
    pd.add_argument("--batch", type=int, default=32)
    pd.add_argument("--platforms", choices=["cuda", "cpu"], default=None,
                    help="the device type to export on (default: --device's)")
    _add_quant_flags(pd)
    pd.set_defaults(fn=cmd_deploy)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
