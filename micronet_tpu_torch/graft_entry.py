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

``dryrun_multichip(n)`` is the training half of the JAX package's
multi-chip dry run: it starts ``n`` ranks (one process a card over NCCL,
or over gloo with ``device="cpu"``), lays out a ``(n / tp, tp)`` mesh
(``tp`` 2 where ``n`` is even) and runs one IAO W8A8 ``bn_fuse`` step of
NIN (widths 8) with the model and Adam channel-sharded, checking that
every data replica holds the same observer ranges and BN running means
bit for bit; then an asymmetric (``q_type=1``) step and a PTQ-KL
calibration forward over the same mesh. Its serving half (the W4
decoder and Llama tensor-parallel, expert-parallel MoE, pipeline and
ring attention) is ROADMAP.md's Queue 1 item 2 and raises
(``serving=True``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ._device import resolve_device

__all__ = ["entry", "dryrun_multichip"]

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


def _dryrun_rank(rank: int, n: int, port: int, device) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as TF

    from .models import nin
    from .nn import prepare, qat_iao, train_mode
    from .parallel import initialize, make_mesh, shard_batch, shard_model_and_optimizer
    from .parallel.distributed import _gather_parts, batch_reduction
    from .parallel.sharding import batch_group_for
    from .quant.config import QuantConfig
    from .train.optim import Adam

    initialize(f"tcp://localhost:{port}", n, rank, device=device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh(dp, tp, device=device)
    batch = 2 * dp
    x = torch.ones((batch, 32, 32, 3), device=dev)
    y = torch.zeros((batch,), dtype=torch.int64, device=dev)
    group = batch_group_for(batch, mesh)

    def step(cfg: QuantConfig, seed: int, train: bool = True):
        q = train_mode(prepare(nin.Net(cfg=[8] * 8, device="cpu",
                                       generator=torch.Generator().manual_seed(seed)),
                               cfg, device="cpu")).to(dev)
        opt = Adam(list(q.parameters()), lr=1e-3)
        shard_model_and_optimizer(q, opt, mesh)
        with batch_reduction(group):
            if not train:
                with torch.no_grad():
                    out = q(shard_batch(x, mesh))
                if not torch.isfinite(out).all():
                    raise RuntimeError("PTQ-KL calibration forward is not finite")
                return q
            loss = TF.cross_entropy(q(shard_batch(x, mesh)), shard_batch(y, mesh))
            loss.backward()
        for p in q.parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            dist.all_reduce(g, group=group)
            p.grad = g / dp
        opt.step()
        if not np.isfinite(float(loss.detach())):
            raise RuntimeError(f"non-finite loss {float(loss.detach())}")
        return q

    q = step(QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), 0)
    # every data replica holds the same observer ranges and BN statistics
    # (slices of the same model rank compared), bit for bit
    checked = 0
    for m in q.modules():
        if isinstance(m, qat_iao.QuantBNFuseConv2d):
            for t in (m.activation_quantizer.min_val, m.activation_quantizer.max_val,
                      m.running_mean):
                reps = _gather_parts(t, group)
                if not all(torch.equal(r, reps[0]) for r in reps[1:]):
                    raise RuntimeError("observer state diverged across replicas")
                checked += len(reps)
    if not checked:
        raise RuntimeError("no quant state found to check")
    step(QuantConfig(a_bits=8, w_bits=8, q_type=1, weight_observer=1), 2)
    step(QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl", pretrained_model=True),
         3, train=False)
    if rank == 0:
        print(f"dryrun_multichip: {n} ranks, mesh ({dp}, {tp}): IAO, asymmetric and PTQ-KL "
              f"steps passed, {checked} replica states equal")
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, *, serving: bool = False) -> None:
    """The training half of the JAX package's multi-chip dry run over
    ``n_devices`` ranks (module docstring); raises on any failure.
    ``device`` None means CUDA (one card a rank)."""
    import socket

    import torch.multiprocessing as mp

    if serving:
        raise NotImplementedError(
            "the dry run's serving half (tensor-parallel decoders, expert-parallel MoE, "
            "pipeline, ring attention) is not ported yet (ROADMAP.md, Queue 1 item 2: "
            "parallelism)")
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dryrun_rank, args=(n_devices, port, device), nprocs=n_devices,
                       start_method="spawn")
