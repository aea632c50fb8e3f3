"""Training: the CIFAR-10 pipeline, the QAT/PTQ/QAFT loop and checkpoints."""

from . import checkpoint, data, loop
from .checkpoint import load_state, save_state, save_state_async, wait_for_saves
from .data import Cifar10, augment_batch, load_cifar10, normalize_batch
from .loop import TrainConfig, Trainer, lr_at_epoch, scaled_milestones

__all__ = ["checkpoint", "data", "loop", "save_state", "save_state_async", "wait_for_saves",
           "load_state", "Cifar10", "load_cifar10", "augment_batch", "normalize_batch",
           "TrainConfig", "Trainer", "lr_at_epoch", "scaled_milestones"]
