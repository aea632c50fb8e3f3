"""Import hygiene of the port: ``micronet_tpu_torch`` and ``chip_smoke.py``
never load JAX or the JAX package, and the port's entry points run on the
card unless the caller asks for the CPU."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import micronet_tpu_torch
from micronet_tpu_torch.models import nin, nin_gc
from micronet_tpu_torch.infer import (build_engine, freeze_wbwtab, fuse_bn_wbwtab,
                                      serialize_engine)
from micronet_tpu_torch.models.llama import Llama, llama_tiny
from micronet_tpu_torch.nn import prepare
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.models.resnet import resnet18
from micronet_tpu_torch.quant.kv_cache import init_kv_cache
from micronet_tpu_torch.quant.paged_kv import init_paged_kv
from micronet_tpu_torch.serve import ServeLoop
from micronet_tpu_torch import cli
from micronet_tpu_torch.models.lenet import LeNet
from micronet_tpu_torch.train import TrainConfig, Trainer
from micronet_tpu_torch.models.tiny_decoder import TinyDecoder
from micronet_tpu_torch.parallel import init_moe
from micronet_tpu_torch.graft_entry import dryrun_multichip, entry as graft_entry
from micronet_tpu_torch.parallel import initialize, make_mesh

ROOT = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        micronet_tpu_torch.__path__, "micronet_tpu_torch."))
    assert "micronet_tpu_torch.serve.scheduler" in mods and len(mods) >= 51
    for m in ("infer.engine", "infer.dataflow", "infer.bn_fuse", "nn.qat_iao", "nn.transform",
              "ops.int_matmul", "models.resnet", "models.nin_gc", "quant.observers",
              "ops.paged_attention", "quant.paged_kv", "quant.wbwtab", "nn.qat_wbwtab",
              "models.nin", "ops.int4_matmul", "quant.weight_only", "quant.dorefa",
              "nn.qat_dorefa", "quant.calibrate", "models.lenet", "selftest", "cli",
              "prune", "prune.slimming", "utils", "utils.metrics", "train", "train.data",
              "train.native_loader", "train.checkpoint", "train.loop", "train.optim",
              "infer.evaluate", "infer.dump", "models.tiny_decoder", "parallel",
              "parallel.moe", "infer.deploy", "infer.bf16", "utils.profiling", "graft_entry",
              "parallel.distributed", "parallel.sharding", "parallel.pipeline",
              "parallel.sequence"):
        assert f"micronet_tpu_torch.{m}" in mods
    code = "\n".join(
        ["import sys", "preloaded = set(sys.modules)"]
        + [f"import {m}" for m in mods]
        + [
            "import importlib.util",
            f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})",
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
            "bad = sorted(m for m in set(sys.modules) - preloaded if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'micronet_tpu'))",
            "print(bad)",
            "sys.exit(1 if bad else 0)",
        ]
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("entry", ["llama", "serve_loop", "paged_serve_loop", "kv_cache",
                                   "paged_kv", "resnet18", "nin_gc", "nin", "prepare_wbwtab",
                                   "fuse_bn_wbwtab", "freeze_wbwtab", "lenet", "prepare_dorefa",
                                   "trainer", "cli", "quant_test_auto", "tiny_decoder",
                                   "init_moe", "tiny_decoder_serve_loop", "build_engine",
                                   "serialize_engine", "graft_entry", "initialize",
                                   "make_mesh", "dryrun_multichip"])
def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_model = Llama(llama_tiny(8), device="cpu")
    cpu_nin = nin.Net(cfg=[8] * 8, device="cpu")
    cpu_decoder = TinyDecoder(vocab=16, dim=16, heads=2, depth=1, mlp_dim=32, max_seq=8,
                              device="cpu")
    calls = {
        "llama": lambda: Llama(llama_tiny(8)),
        "serve_loop": lambda: ServeLoop(cpu_model, 2),
        "paged_serve_loop": lambda: ServeLoop(cpu_model, 2, paged=True, page_size=4),
        "kv_cache": lambda: init_kv_cache(2, 8, 4),
        "paged_kv": lambda: init_paged_kv(4, 2, 1, 8, 1, 2),
        "resnet18": lambda: resnet18(),
        "nin_gc": lambda: nin_gc.Net(cfg=[16] * 8),
        "nin": lambda: nin.Net(cfg=[8] * 8),
        "prepare_wbwtab": lambda: prepare(cpu_nin, method="wbwtab"),
        "fuse_bn_wbwtab": lambda: fuse_bn_wbwtab(prepare(cpu_nin, method="wbwtab",
                                                         device="cpu"), QuantConfig()),
        "freeze_wbwtab": lambda: freeze_wbwtab(cpu_nin),
        "lenet": lambda: LeNet(),
        "prepare_dorefa": lambda: prepare(cpu_nin, method="dorefa"),
        "trainer": lambda: Trainer(cpu_nin, TrainConfig(), dataset=object()),
        "cli": lambda: cli.main(["prune", "--cfg", "8,8,8,8,8,8,8,8"]),
        "quant_test_auto": lambda: micronet_tpu_torch.quant_test_auto(),
        "tiny_decoder": lambda: TinyDecoder(moe_experts=4),
        "init_moe": lambda: init_moe(16, 32, 4),
        "tiny_decoder_serve_loop": lambda: ServeLoop(cpu_decoder, 2),
        "build_engine": lambda: build_engine(cpu_nin),
        "serialize_engine": lambda: serialize_engine(cpu_nin, batch=2),
        "graft_entry": lambda: graft_entry(),
        "initialize": lambda: initialize("tcp://localhost:1", 1, 0),
        "make_mesh": lambda: make_mesh(1, 1),
        "dryrun_multichip": lambda: dryrun_multichip(2),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
