"""Training loop (QAT, PTQ, QAFT and float): the counterpart of
``micronet_tpu/train/loop.py``.

Eager PyTorch with autograd doing the backward. A training step is:
augmentation on the device, forward in training mode (observers and BN
statistics update inside the forward, under ``torch.no_grad``), mean
cross-entropy, backward, an optional gradient hook (``-sr``'s BN L1
term), then one optimizer step. The optimizer is the JAX package's
``optax.adam`` (``optax.adamw``, decoupled weight decay, when
``weight_decay`` is set), in optax's arithmetic (``optim.Adam``), over
every ``nn.Parameter``, as optax updates every ``nnx.Param``: a parameter
that took no gradient takes a zero one. The learning rate is set per
epoch (``lr_at_epoch``).

Kept from the JAX package: LR x0.1 at the milestones; PTQ as
forward-only steps over at most ``ptq_batch`` batches an epoch (capped at
2 epochs with ``ptq_control``) and the KL thresholds resolved after each
calibration epoch; checkpoints on a better test accuracy (and every epoch
with ``keep_latest``); ``grad_accum`` microbatches whose gradients
average into one update.

Random draws (epoch permutation seeds, crop offsets, flips) come from one
CPU ``torch.Generator`` seeded with ``seed``, so a run on the card and
on the CPU sees the same batches; they cannot be JAX's ``jax.random``
draws. Every step runs with cuDNN's deterministic algorithms (and the
caller's setting back afterwards): cuDNN's default weight-gradient
convolutions sum in an order that varies between runs, so the same seed
would not give the same trained net on the card, as the JAX package's
does. ``remat`` recomputes the whole forward in the backward
(``torch.utils.checkpoint``, as ``nnx.remat`` wraps it in the JAX
package), from the observer and BN statistics as they were before the
forward.

``mesh=`` (a ``parallel.make_mesh`` mesh; one process per card, each
with its own ``Trainer`` built the same way) runs data and tensor
parallelism, the counterpart of the JAX trainer's GSPMD step: the model
and Adam's moments are channel-sharded over the ``model`` axis
(``parallel.shard_model_and_optimizer``); every rank draws the global
batch's permutation and augmentation from the one seeded generator and
takes its rows (``parallel.shard_batch``); the observers and BN batch
statistics are global over the ``data`` axis (a
``parallel.distributed.batch_reduction`` around the step; a ragged,
replicated batch reduces over nothing); after the backward one flat
all-reduce averages the gradients (with the loss and accuracy) over the
``data`` axis, so every rank takes the same update. Eval sums its counts
over the axis. Only rank 0 logs and writes metrics and checkpoints (the
whole state, gathered from every rank: ``parallel.unsharded``).

A step records the spans (``utils/profiling.py``; off by default)
``train.step`` around ``train_step``'s body and, inside it,
``train.forward`` (the forward and the loss), ``train.backward``
(``loss.backward()``; autograd launches its kernels from its own thread)
and ``train.optimizer`` (the zero fill of missing gradients, the
gradient hook and ``optimizer.step()``); the augmentation records
``train.augment`` (``data.apply_augment``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as TF
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..nn.modules import eval_mode, train_mode
from ..parallel.distributed import all_reduce_, batch_group, batch_reduction
from ..parallel.sharding import (batch_group_for, check_mesh, shard_batch,
                                 shard_model_and_optimizer, unsharded)
from ..utils.metrics import MetricsLogger
from ..utils.profiling import span
from . import data as data_lib
from .checkpoint import save_state, save_state_async, wait_for_saves
from .optim import Adam

__all__ = ["TrainConfig", "Trainer", "lr_at_epoch", "scaled_milestones"]

MILESTONES = (80, 130, 180, 230, 280)


def lr_at_epoch(base_lr: float, epoch: int, milestones=MILESTONES) -> float:
    """Step decay: x0.1 at each milestone crossed."""
    lr = base_lr
    for m in milestones:
        if epoch >= m:
            lr *= 0.1
    return lr


def scaled_milestones(epochs: int, reference_epochs: int = 300):
    """The milestone schedule for a shorter budget: the reference epochs
    as they are from ``reference_epochs`` on, else two decays at 60 % and
    85 % of the budget."""
    if epochs >= reference_epochs:
        return MILESTONES
    return tuple(sorted({max(1, round(0.60 * epochs)), max(2, round(0.85 * epochs))}))


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 0.0
    batch_size: int = 256
    epochs: int = 300
    milestones: tuple = MILESTONES
    seed: int = 1
    ptq: bool = False
    ptq_batch: int = 200  # forward-only calibration batches an epoch
    ptq_control: bool = False  # cap a PTQ run at 2 epochs
    calib_cache: Optional[str] = None  # KL calibration table file
    metrics_path: Optional[str] = None  # JSONL metrics file
    async_checkpoint: bool = False  # write checkpoints on a background thread
    keep_latest: bool = False  # also write <save>.latest.npz every epoch
    log_every: int = 100  # per-batch log cadence; <= 0 turns it off
    # recompute the forward's activations in the backward instead of keeping
    # them (a whole-forward checkpoint): less activation memory, more time
    remat: bool = False
    grad_accum: int = 1  # microbatches per optimizer step


def _deterministic(step: Callable) -> Callable:
    """``step`` under cuDNN's deterministic algorithms (benchmark off),
    the previous settings put back when it returns."""

    @functools.wraps(step)
    def run(*args, **kwargs):
        cudnn = torch.backends.cudnn
        prev = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            return step(*args, **kwargs)
        finally:
            cudnn.deterministic, cudnn.benchmark = prev

    return run


def _remat_forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` under one non-reentrant activation checkpoint: the
    backward recomputes the forward. The forward writes buffers (observer
    ranges and qparams, BN running statistics); the recompute runs on
    copies of them as they were before the forward and leaves the
    forward's own in place afterwards, so the observers update once and a
    remat step equals a plain step. The recompute (on the backward's
    thread) reduces its batch statistics over the forward's batch group."""
    before = [(m, name, buf.clone()) for m in model.modules()
              for name, buf in m.named_buffers(recurse=False)]
    group = batch_group()

    @contextlib.contextmanager
    def from_before():
        after = [(m, name, getattr(m, name)) for m, name, _ in before]
        for m, name, buf in before:
            setattr(m, name, buf.clone())
        try:
            yield
        finally:
            for m, name, buf in after:
                setattr(m, name, buf)

    @contextlib.contextmanager
    def recompute():
        with from_before(), batch_reduction(group):
            yield

    return checkpoint(model, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


class _StepClock:
    """Per-step times without a sync per step: CUDA events on the card,
    the host clock on the CPU; read once the epoch has synced."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self):
        m = self.marks
        if self.cuda:
            return [m[i].elapsed_time(m[i + 1]) for i in range(len(m) - 1)]
        return [(m[i + 1] - m[i]) * 1e3 for i in range(len(m) - 1)]


class Trainer:
    """Drives QAT, PTQ, QAFT or float training of a prepared (or float)
    model on ``device`` (None = CUDA, which raises without a card).

    ``grad_hook(model)``, when set, runs between the backward and the
    optimizer step (the CLI's ``-sr`` sets ``bn_l1_grad_update`` there).
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 dataset: Optional[data_lib.Cifar10] = None, mesh=None, *, device=None):
        if mesh is not None:
            check_mesh(mesh)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.mesh = mesh
        # rank 0 logs and writes metrics and checkpoints
        self.writer = mesh is None or dist.get_rank() == 0
        self.metrics = MetricsLogger(cfg.metrics_path if self.writer else None)
        self.data = dataset or data_lib.load_cifar10()
        self.best_acc = 0.0
        self.epoch = 0
        self.params = list(model.parameters())
        self.optimizer = Adam(self.params, lr=cfg.lr, weight_decay=cfg.weight_decay)
        if mesh is not None:
            shard_model_and_optimizer(self.model, self.optimizer, mesh)
        self.gen = torch.Generator().manual_seed(cfg.seed)
        self.grad_hook: Optional[Callable[[nn.Module], None]] = None
        self._dev_data = None

    # -- steps --------------------------------------------------------------

    def _loss(self, x: torch.Tensor, labels: torch.Tensor):
        with span("train.forward"):
            logits = _remat_forward(self.model, x) if self.cfg.remat else self.model(x)
            return TF.cross_entropy(logits, labels), logits

    def _local(self, x: torch.Tensor, labels: torch.Tensor):
        """This rank's rows of a global batch and the group its statistics
        reduce over (None without a mesh, or for a replicated batch)."""
        if self.mesh is None:
            return x, labels, None
        return (shard_batch(x, self.mesh), shard_batch(labels, self.mesh),
                batch_group_for(x.shape[0], self.mesh))

    @staticmethod
    def _mean_over(group, tensors):
        """Each tensor averaged over ``group`` in place, through one flat
        all-reduce (a SUM, then the division)."""
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), "sum", group)
        flat = flat / dist.get_world_size(group)
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()

    @_deterministic
    def train_step(self, x: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on the augmented (global) batch ``x``; returns
        the (mean loss, accuracy) as device tensors."""
        with span("train.step"):
            x, labels, group = self._local(x, labels)
            with batch_reduction(group):
                loss, acc = self._backward(x, labels)
            with span("train.optimizer"):
                for p in self.params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            if group is not None:
                loss, acc = loss.clone(), acc.clone()
                self._mean_over(group, [p.grad for p in self.params] + [loss, acc])
            with span("train.optimizer"):
                if self.grad_hook is not None:
                    self.grad_hook(self.model)
                self.optimizer.step()
            return loss, acc

    def _backward(self, x: torch.Tensor, labels: torch.Tensor):
        """Forward and backward (``grad_accum`` microbatches whose gradients
        average); returns the detached (mean loss, accuracy)."""
        accum = max(int(self.cfg.grad_accum), 1)
        for p in self.params:
            p.grad = None
        if accum == 1:
            loss, logits = self._loss(x, labels)
            with span("train.backward"):
                loss.backward()
            acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        else:
            # microbatches in order: observers and BN statistics update per
            # microbatch, the gradients sum, then average
            n = x.shape[0] - x.shape[0] % accum
            m = n // accum
            loss, correct = 0.0, 0
            for i in range(accum):
                li, logits = self._loss(x[i * m:(i + 1) * m], labels[i * m:(i + 1) * m])
                with span("train.backward"):
                    li.backward()
                loss = loss + li.detach()
                correct = correct + (logits.argmax(-1) == labels[i * m:(i + 1) * m]).sum()
            for p in self.params:
                if p.grad is not None:
                    p.grad.div_(accum)
            loss, acc = loss / accum, correct.to(torch.float32) / n
        return loss.detach(), acc

    @_deterministic
    @torch.no_grad()
    def forward_step(self, x: torch.Tensor, labels: torch.Tensor):
        """A PTQ calibration step: the forward updates the observers."""
        x, labels, group = self._local(x, labels)
        with batch_reduction(group):
            loss, logits = self._loss(x, labels)
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        if group is not None:
            self._mean_over(group, [loss, acc])
        return loss, acc

    @_deterministic
    @torch.no_grad()
    def eval_step(self, images_u8: torch.Tensor, labels: torch.Tensor):
        """The (summed loss, correct count) of a global batch."""
        images_u8, labels, group = self._local(images_u8, labels)
        logits = self.model(data_lib.normalize_batch(images_u8))
        loss = TF.cross_entropy(logits, labels, reduction="sum")
        correct = (logits.argmax(-1) == labels).sum()
        if group is None:
            return loss, correct
        sums = all_reduce_(torch.stack([loss, correct.to(loss.dtype)]), "sum", group)
        return sums[0], sums[1].to(correct.dtype)

    # -- data ---------------------------------------------------------------

    def _device_dataset(self):
        """The whole set, uploaded once; batches are gathered on the device."""
        if self._dev_data is None:
            d, dev = self.data, self.device
            self._dev_data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                d.train_images, d.train_labels.astype(np.int64), d.test_images,
                d.test_labels.astype(np.int64)))
        return self._dev_data

    def _train_batches(self, batch_size: int):
        tx, tl, _, _ = self._device_dataset()
        n = tx.shape[0]
        idx = np.arange(n)
        np.random.RandomState(data_lib.perm_seed(self.gen)).shuffle(idx)
        idx = torch.from_numpy(idx).to(self.device)
        xp, lp = tx[idx], tl[idx]
        for i in range(0, (n // batch_size) * batch_size, batch_size):
            yield xp[i:i + batch_size], lp[i:i + batch_size]

    def _eval_batches(self):
        _, _, ex, el = self._device_dataset()
        bs = self.cfg.batch_size
        for i in range(0, ex.shape[0], bs):
            yield ex[i:i + bs], el[i:i + bs]

    # -- epochs -------------------------------------------------------------

    def _log(self, log: Callable[[str], None]) -> Callable[[str], None]:
        return log if self.writer else (lambda _msg: None)

    def _save(self, saver, path: str, **kw) -> None:
        """A checkpoint of the whole state, written by rank 0 (every rank
        takes part in gathering a sharded one)."""
        with unsharded(self.model, self.optimizer) if self.mesh is not None \
                else contextlib.nullcontext():
            if self.writer:
                saver(path, self.model, optimizer=self.optimizer, **kw)

    def train_epoch(self, epoch: int, log: Callable[[str], None] = print) -> float:
        log = self._log(log)
        cfg = self.cfg
        train_mode(self.model)
        lr = lr_at_epoch(cfg.lr, epoch, cfg.milestones)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        losses = []
        clock = _StepClock(self.device)
        t0 = time.time()
        for i, (xb, yb) in enumerate(self._train_batches(cfg.batch_size)):
            if cfg.ptq and i >= cfg.ptq_batch:
                break
            clock.mark()
            offsets, flips = data_lib.draw_augment(self.gen, xb.shape[0])
            x = data_lib.apply_augment(xb, offsets, flips)
            if cfg.ptq:
                loss, acc = self.forward_step(x, yb)
            else:
                loss, acc = self.train_step(x, yb)
            # the loss stays on the device: no sync per step
            losses.append(loss)
            if cfg.log_every > 0 and i % cfg.log_every == 0:
                log(f"epoch {epoch} batch {i}: loss {float(loss):.4f} acc {float(acc):.4f} "
                    f"lr {lr:.2e}")
        clock.mark()
        if losses:
            losses = [float(v) for v in torch.stack(losses).cpu()]
        dt = time.time() - t0
        n_img = len(losses) * cfg.batch_size
        log(f"epoch {epoch} done in {dt:.1f}s ({n_img / max(dt, 1e-9):.1f} img/s)")
        if cfg.ptq:
            self._maybe_finalize_entropy(log)
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        self.metrics.log("epoch", epoch=epoch, loss=mean_loss, lr=lr,
                         img_per_s=round(n_img / max(dt, 1e-9), 1), seconds=round(dt, 2),
                         step_ms=clock.step_ms(), step_loss=losses)
        return mean_loss

    def _maybe_finalize_entropy(self, log: Callable[[str], None]) -> None:
        """KL PTQ: resolve the thresholds after each calibration epoch."""
        from ..nn.qat_iao import FakeQuantizer
        from ..quant.calibrate import finalize_entropy_calibration

        if any(isinstance(m, FakeQuantizer) and m.observer == "entropy"
               for m in self.model.modules()):
            table = finalize_entropy_calibration(
                self.model, cache=self.cfg.calib_cache if self.writer else None)
            log(f"entropy calibration resolved {len(table)} thresholds")

    def evaluate(self) -> Tuple[float, float]:
        """(mean loss, accuracy) over the test set, in eval mode."""
        eval_mode(self.model)
        total_loss, total_correct, n = 0.0, 0, 0
        for xb, yb in self._eval_batches():
            loss, correct = self.eval_step(xb, yb)
            total_loss = total_loss + loss
            total_correct = total_correct + correct
            n += len(yb)
        return float(total_loss) / max(n, 1), int(total_correct) / max(n, 1)

    def fit(self, epochs: Optional[int] = None, checkpoint_path: Optional[str] = None,
            log: Callable[[str], None] = print, checkpoint_extra: Optional[dict] = None,
            restore_best: bool = False) -> float:
        """Train; returns the best test accuracy seen. ``restore_best``
        keeps the best epoch's state in memory and loads it back before
        returning, so the model handed on is the one ``best_acc``
        describes."""
        log = self._log(log)
        cfg = self.cfg
        end = epochs if epochs is not None else cfg.epochs
        if cfg.ptq and cfg.ptq_control:
            end = min(end, 2)
        best_state = None
        saver = save_state_async if cfg.async_checkpoint else save_state
        for epoch in range(self.epoch, end):
            self.train_epoch(epoch, log)
            _, acc = self.evaluate()
            log(f"epoch {epoch}: test acc {acc * 100:.2f}% (best {self.best_acc * 100:.2f}%)")
            self.metrics.log("eval", epoch=epoch, acc=acc, best_acc=max(acc, self.best_acc))
            if acc > self.best_acc:
                self.best_acc = acc
                if restore_best:
                    best_state = {k: v.detach().clone()
                                  for k, v in self.model.state_dict().items()}
                if checkpoint_path:
                    self._save(saver, checkpoint_path, step=epoch, best_acc=self.best_acc,
                               extra=checkpoint_extra)
                    log(f"saved best checkpoint to {checkpoint_path}")
            if checkpoint_path and cfg.keep_latest:
                self._save(saver, checkpoint_path + ".latest.npz", step=epoch,
                           best_acc=self.best_acc, extra=checkpoint_extra)
            self.epoch = epoch + 1
        if cfg.async_checkpoint:
            wait_for_saves()
        if restore_best and best_state is not None:
            self.model.load_state_dict(best_state)
        return self.best_acc
