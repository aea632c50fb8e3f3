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
from micronet_tpu_torch.models.llama import Llama, llama_tiny
from micronet_tpu_torch.quant.kv_cache import init_kv_cache
from micronet_tpu_torch.serve import ServeLoop

ROOT = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        micronet_tpu_torch.__path__, "micronet_tpu_torch."))
    assert "micronet_tpu_torch.serve.scheduler" in mods and len(mods) >= 15
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


@pytest.mark.parametrize("entry", ["llama", "serve_loop", "kv_cache"])
def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_model = Llama(llama_tiny(8), device="cpu")
    calls = {
        "llama": lambda: Llama(llama_tiny(8)),
        "serve_loop": lambda: ServeLoop(cpu_model, 2),
        "kv_cache": lambda: init_kv_cache(2, 8, 4),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
