"""The system under test, micronet_tpu_torch, as the benchmark drives it:
a float model built from a configuration and loaded with the benchmark's
weights, its IAO calibration into the integer engine, and its trainer.
Only this module and the traffic runners import the program, and only
inside functions."""

from __future__ import annotations

import importlib
import time
from typing import Dict

import numpy as np
import torch


def float_model(config: dict, weights: Dict[str, torch.Tensor], device):
    """The configuration's float model (``model.factory`` as
    ``module:callable`` with ``model.kwargs``) on ``device``, its every
    parameter and BN buffer replaced by ``weights``."""
    mod_name, attr = config["model"]["factory"].split(":")
    factory = getattr(importlib.import_module(mod_name), attr)
    model = factory(**config["model"].get("kwargs", {}), device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    model.load_state_dict(weights, strict=True)
    return model


def quant_config(config: dict, lowerings: dict):
    from micronet_tpu_torch.quant.config import QuantConfig

    return QuantConfig(**config["quant"], **lowerings)


@torch.no_grad()
def calibrated_engine(config: dict, weights, calib, example, batch: int, device):
    """``prepare`` with the configuration's IAO recipe, one training-mode
    forward per calibration batch, ``fuse_bn_iao``, ``freeze_int`` traced on
    ``example``, then ``build_engine`` with the one bucket ``batch``."""
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.infer.deploy import build_engine
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode

    cfg = quant_config(config, config["calibration_lowerings"])
    q = train_mode(prepare(float_model(config, weights, device), cfg, inplace=True,
                           device=device))
    for x in calib:
        q(x)
    fused = fuse_bn_iao(eval_mode(q), cfg, inplace=True, device=device)
    engine = freeze_int(eval_mode(fused), inplace=True, example_input=example[:1],
                        device=device)
    return build_engine(eval_mode(engine), profile=(batch, batch, batch), device=device)


def trainer(config: dict, weights, train: dict, mesh, device):
    """A ``Trainer`` over the prepared model (the configuration's training
    lowerings), Adam at ``train['lr']`` and ``train['weight_decay']``,
    with an empty dataset: the benchmark feeds ``train_step`` itself."""
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.train.data import Cifar10
    from micronet_tpu_torch.train.loop import TrainConfig, Trainer

    from . import harness

    t = time.time()
    cfg = quant_config(config, config["train_lowerings"])
    model = float_model(config, weights, device)
    t = harness.phase("float model", t)
    q = train_mode(prepare(model, cfg, inplace=True, device=device))
    t = harness.phase("prepare", t)
    empty = Cifar10(np.zeros((0, 32, 32, 3), np.uint8), np.zeros((0,), np.int32),
                    np.zeros((0, 32, 32, 3), np.uint8), np.zeros((0,), np.int32), "benchmark")
    tcfg = TrainConfig(lr=train["lr"], weight_decay=train["weight_decay"],
                       batch_size=train["batch"], log_every=0)
    trainer = Trainer(q, tcfg, dataset=empty, mesh=mesh, device=device)
    harness.phase("Trainer", t)
    return trainer


def augment(images_u8, offsets, flips):
    """The program's augmentation of one batch at the benchmark's crop
    ``offsets`` and ``flips``."""
    from micronet_tpu_torch.train import data

    return data.apply_augment(images_u8, offsets, flips)


def program_leaf(name: str, conv_to_bn: Dict[str, str]) -> str:
    """The reference's key of the prepared model's parameter ``name``: a
    fused conv's ``gamma`` and ``beta`` are its BN's ``weight`` and
    ``bias``."""
    head, _, leaf = name.rpartition(".")
    if leaf in ("gamma", "beta"):
        return f"{conv_to_bn[head]}.{'weight' if leaf == 'gamma' else 'bias'}"
    return name


def init_distributed(rank: int, world: int, init_method: str, device):
    """The process group of one rank (NCCL on the card, gloo on the CPU)
    and the data-parallel mesh over every rank."""
    from micronet_tpu_torch.parallel import make_mesh
    from micronet_tpu_torch.parallel.distributed import initialize

    initialize(init_method, world, rank, device=device)
    return make_mesh(world, 1, device=device)
