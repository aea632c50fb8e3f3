"""PyTorch/CUDA port of ``micronet_tpu``: so far its LLM serving paths
(dense, paged, long-context) and its IAO and wbwtab compression flows down
to their integer engines.

The JAX package ``micronet_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``quant/``, ``nn/``, ``models/``, ``infer/``,
``serve/``) so each module has a counterpart there. Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA kernel for Hopper (``ops/csrc/``), with a plain PyTorch
twin beside it that runs only for tensors on the CPU.

This package imports ``torch`` and numpy only: never ``jax``, ``flax`` or
anything under ``micronet_tpu``.
"""

from ._device import on_cuda, resolve_device

__all__ = ["on_cuda", "resolve_device"]
