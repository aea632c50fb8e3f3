"""Device resolution for the port: the counterpart of
``micronet_tpu/ops/_dispatch.py::on_tpu``.

Entry points (``Llama``, ``ServeLoop``) run on the card unless the caller
asks for the CPU. There is no silent fallback: asking for CUDA on a
machine without a card raises. Kernel wrappers never resolve a device
themselves; they take the device of the tensors they are given, and use
the plain PyTorch twin only for tensors that lie on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "on_cuda"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and no card is
    present, rather than running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """True iff an op on ``t`` runs on the card (and so must launch the
    hand-written kernel)."""
    return t.device.type == "cuda"
