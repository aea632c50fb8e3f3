"""A compile-and-run entry point: the counterpart of ``__graft_entry__.entry()``.

    from micronet_tpu_torch.graft_entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    with torch.no_grad():
        logits = fn(*args)        # (64, 10)

The forward is the flagship configuration's eval forward: NIN-GC at its
default widths, IAO W8A8 with per-channel weights and BN folded in
training (``QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)``), in eval
mode. The config keeps the default ``"auto"`` lowerings, so on the card
the forward runs the code-storage convs (bf16 codes) and on the CPU the
exact f32 composition. The weights are drawn from a CPU generator seeded
with 0, so every device gets the same ones; the example input is a zero
batch of 64 NHWC images, as the JAX entry's.

The JAX package's multi-chip dry run (``dryrun_multichip``) waits for the
port of its parallel modes.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ._device import resolve_device

__all__ = ["entry"]

EXAMPLE_BATCH = 64


def entry(device=None) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor, ...]]:
    """``(fn, example_args)``: ``fn`` is the prepared NIN-GC (an
    ``nn.Module`` in eval mode) on ``device`` (None means CUDA, which
    raises without a card), ``example_args`` its (64, 32, 32, 3) f32 zero
    input."""
    from .models import nin_gc
    from .nn import eval_mode, prepare
    from .quant.config import QuantConfig

    dev = resolve_device(device)
    model = nin_gc.Net(device="cpu", generator=torch.Generator().manual_seed(0))
    q = prepare(model, QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), method="iao",
                device="cpu")
    fn = eval_mode(q).to(dev)
    return fn, (torch.zeros((EXAMPLE_BATCH, 32, 32, 3), device=dev),)
