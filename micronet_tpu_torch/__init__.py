"""PyTorch/CUDA port of ``micronet_tpu``: its LLM serving paths (dense,
paged, long-context, the TinyDecoder), its IAO, DoReFa and wbwtab
compression flows down to their integer engines and the deploy end
(CUDA-graph batch buckets, ``torch.export`` artifacts, bf16), and the
QAT/PTQ training path with its CLI (``python -m micronet_tpu_torch.cli``).

The JAX package ``micronet_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``quant/``, ``nn/``, ``models/``, ``infer/``,
``serve/``, ``train/``, ``prune/``, ``utils/``) so each module has a
counterpart there. Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas for the TPU is a hand-written CUDA kernel for
Hopper (``ops/csrc/``), with a plain PyTorch twin beside it that runs only
for tensors on the CPU.

This package imports ``torch`` and numpy only: never ``jax``, ``flax`` or
anything under ``micronet_tpu``.
"""

__version__ = "0.1.0"

from . import quant
from ._device import on_cuda, resolve_device
from .quant.config import QuantConfig
from .selftest import quant_test_auto, quant_test_manual

__all__ = ["quant", "QuantConfig", "quant_test_manual", "quant_test_auto", "__version__",
           "on_cuda", "resolve_device"]


def __getattr__(name):
    # the other subpackages load on first use, as in the JAX package
    if name in ("nn", "models", "train", "prune", "infer", "ops", "parallel", "utils", "serve"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
