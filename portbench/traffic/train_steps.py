"""Training steps: ``Trainer.train_step`` back to back at a fixed global
batch, on one card or data-parallel over ``ranks`` cards (one process a
card, ``Trainer(mesh=make_mesh(ranks, 1))`` over NCCL). Batches come in
epochs of a seeded permutation of a uint8 training set made on the
device; each is augmented on the device by the program's augmentation,
at crop offsets and flips that the benchmark draws from a seeded
generator (so the reference replays draws that the program did not make).

Set-up builds the trainer and runs its first ``check_steps`` steps
through the same call and feed as the window, reading each step's loss,
the first gradient (Adam's first moment after one step) and every leaf's
change over those steps; the reference follows the same steps from the
same inputs once the window is over. Under several ranks, rank 0 ends
the window: every ``STOP_EVERY`` steps it tells the others over a gloo
group whether the time is up, so every rank runs the same steps (the
host of each rank waits for rank 0's there, so not at every step); one
rank looks at the clock after every step.

Mix parameters: ``ranks``, ``batch`` (global), ``dataset`` (images),
``lr``, ``weight_decay``, ``check_steps``, ``trace_steps``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from .. import compare, harness, program, tracing, weights, work
from ..reference import arch
from ..reference.iao import IaoNet
from ..reference.train import run_steps

# steps between rank 0's word to the other ranks on whether the window is over
STOP_EVERY = 8


def _feed(images, labels, batch, gen, aug_gen, device):
    """``(x, labels, record)`` batches; ``record`` is what the reference
    needs to make the same batch: the uint8 images, labels, crop offsets
    (rows, columns in 0..8) and flips, each row's drawn on its own from
    ``aug_gen``."""
    n = images.shape[0]
    while True:
        perm = torch.randperm(n, generator=gen, device=device)
        for i in range(0, n - batch + 1, batch):
            idx = perm[i:i + batch]
            xu8, y = images[idx], labels[idx]
            offsets = torch.randint(0, 9, (batch, 2), generator=aug_gen, device=device)
            flips = torch.rand(batch, generator=aug_gen, device=device) < 0.5
            x = program.augment(xu8, offsets, flips)
            yield x, y, (xu8, y, offsets, flips)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_net(run, ops, w, device, dtype=torch.float32) -> IaoNet:
    """The reference network computing what the configuration's training
    lowerings state on ``device``: the batch statistics of the quantized
    accumulator (``acc``; ``auto`` takes it on a card) or of the float conv,
    and the quantized convs over bfloat16 codes (``act_codes``; ``auto`` on
    a card)."""
    low, cuda = run.config["train_lowerings"], device.type == "cuda"
    acc = low["bn_stats"] == "acc" or (low["bn_stats"] == "auto" and cuda)
    codes = cuda and low["act_codes"] in ("on", "auto")
    quant = run.config["quant"]
    return IaoNet(ops, w, quant["a_bits"], quant["w_bits"], stats="acc" if acc else "exact",
                  dtype=dtype, codes_dtype=torch.bfloat16 if codes else None)


def rank_main(rank: int, world: int, rendezvous: str, run, out_dir: str) -> None:
    """One rank's run (``rendezvous``: the process group's init method);
    rank 0 writes the result to ``out_dir``."""
    tr = run.traffic
    cuda = run.device == "cuda"
    device = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
    if world > 1:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    t = time.time()
    mesh = ctl = None
    if world > 1:
        mesh = program.init_distributed(rank, world, rendezvous, device.type)
        ctl = dist.new_group(backend="gloo")
    ops = work.arch_ops(run.config)
    gen = weights.generator(run.seed, device)
    w = weights.make_weights(ops, gen, device)
    images, labels = weights.uint8_set(gen, device, tr["dataset"])
    feed = _feed(images, labels, tr["batch"], gen, weights.generator(run.seed + 1, device),
                 device)
    t = harness.phase(f"rank {rank}: process group and inputs", t)
    trainer = program.trainer(run.config, w, tr, mesh, device)
    t = harness.phase(f"rank {rank}: trainer", t)
    conv_to_bn = {c["conv"]: c["bn"] for c in arch.conv_layers(ops)}
    named = [(program.program_leaf(n, conv_to_bn), p) for n, p in
             trainer.model.named_parameters()]
    start = {k: p.detach().clone() for k, p in named}
    b1 = trainer.optimizer.param_groups[0]["b1"]
    readings = dict(losses=[], grad={}, delta={})
    records = []
    for i in range(tr["check_steps"]):
        x, y, rec = next(feed)
        records.append(rec)
        loss, _ = trainer.train_step(x, y)
        readings["losses"].append(float(loss))
        if i == 0:  # Adam's first moment after one step is (1 - b1) x the gradient
            state = trainer.optimizer.state
            readings["grad"] = {k: float(state[p]["mu"].double().norm()) / (1 - b1)
                                if "mu" in state[p] else 0.0 for k, p in named}
    readings["delta"] = {k: float((p.detach() - start[k]).double().norm()) for k, p in named}
    del start
    harness.phase(f"rank {rank}: first steps", t)

    def step():
        x, y, _ = next(feed)
        return trainer.train_step(x, y)[0]

    def barrier():
        _sync(device)
        if ctl is not None:
            dist.barrier(group=ctl)

    # -- the measured window --------------------------------------------
    barrier()
    t0 = time.perf_counter()
    setup_s = time.time() - run.t_start
    deadline = t0 + run.seconds
    flag = torch.zeros(1)
    stop_every = STOP_EVERY if ctl is not None else 1
    losses = []
    while True:
        losses.append(step())
        if len(losses) % stop_every:
            continue
        if rank == 0:
            flag[0] = float(time.perf_counter() >= deadline)
        if ctl is not None:
            dist.broadcast(flag, 0, group=ctl)
        if flag[0]:
            break
    barrier()
    t1 = time.perf_counter()
    # ---------------------------------------------------------------------
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    stretch = tracing.trace_stretch(step, tr["trace_steps"], device) if run.trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    mine = dict(busy_s=stretch["busy_s"] if stretch else None, peak=peak,
                forbidden=harness.forbidden_modules())
    every = [mine]
    if ctl is not None:
        every = [None] * world
        dist.gather_object(mine, every if rank == 0 else None, dst=0, group=ctl)
    del trainer, feed, step
    if cuda:
        torch.cuda.empty_cache()
    if ctl is not None:
        dist.destroy_process_group()
    if rank != 0:
        return
    if stretch is not None:
        stretch["busy_s_rank0"] = stretch["busy_s"]
        stretch["busy_s"] = sum(e["busy_s"] for e in every) / len(every)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = compare.train_numbers(readings, run_steps(reference_net(run, ops, w, device),
                                                        records, tr["lr"], tr["weight_decay"]))
    numbers.update(program_losses=readings["losses"])
    out = dict(setup_s=setup_s, stretch=stretch, numbers=numbers,
               memory_peak_bytes=max(e["peak"] for e in every),
               checks=compare.checks(numbers, run.spec["limits"]), attempted=len(losses),
               failed=nonfinite, forbidden=sorted({m for e in every for m in e["forbidden"]}),
               window=dict(kind="train", ranks=world, steps=len(losses),
                           images=len(losses) * tr["batch"], seconds=t1 - t0))
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(out, f)


def run(run, entry=rank_main) -> None:
    """Run the cell's ranks (``entry``, a module-level function of
    :func:`rank_main`'s arguments, so that spawned processes find it)."""
    world = int(run.traffic["ranks"])
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        if world == 1:
            entry(0, 1, "", run, out_dir)
        else:
            import torch.multiprocessing as mp

            # a file store in this run's own temporary directory: no port to race for
            rendezvous = "file://" + os.path.join(out_dir, "rendezvous")
            mp.start_processes(entry, args=(world, rendezvous, run, out_dir), nprocs=world,
                               start_method="spawn")
        with open(os.path.join(out_dir, "result.json")) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    run.setup_s, run.stretch, run.window = out["setup_s"], out["stretch"], out["window"]
    run.memory_peak_bytes, run.attempted, run.failed = (out["memory_peak_bytes"],
                                                       out["attempted"], out["failed"])
    run.checks = [tuple(c) for c in out["checks"]]
    run.numbers = out["numbers"]
    run.window["forbidden"] = out["forbidden"]
    run.cards = world if run.device == "cuda" else 1
