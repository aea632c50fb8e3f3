"""Paired train/inference equivalence evaluation: the counterpart of
``micronet_tpu/infer/evaluate.py``. One checkpoint loads into a train-mode
architecture and an inference architecture; both must reach the same
accuracy, and both report their throughput."""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.modules import eval_mode
from ..train import data as data_lib

__all__ = ["evaluate_model", "paired_equivalence_eval"]


def _device_of(model: nn.Module) -> torch.device:
    for t in list(model.parameters()) + list(model.buffers()):
        return t.device
    return torch.device("cpu")


@torch.no_grad()
def evaluate_model(model: nn.Module, images: np.ndarray, labels: np.ndarray,
                   batch_size: int = 256) -> Tuple[float, float]:
    """(accuracy, img/s) over a test set, in eval mode on the model's
    device. The first batch is left out of the time (allocations and
    cuDNN's choices); each batch syncs, as the JAX package's does."""
    eval_mode(model)
    dev = _device_of(model)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    correct, n, n_timed, t0 = 0, 0, 0, None
    for xb, yb in data_lib.epoch_batches(None, images, labels, batch_size, shuffle=False,
                                         drop_remainder=False):
        pred = model(data_lib.normalize_batch(torch.from_numpy(xb).to(dev))).argmax(-1)
        sync()
        if t0 is None:
            t0 = time.time()
        else:
            n_timed += len(yb)
        correct += int((pred.cpu() == torch.from_numpy(yb.astype(np.int64))).sum())
        n += len(yb)
    dt = max(time.time() - t0, 1e-9) if t0 is not None else 1e-9
    return correct / max(n, 1), (n_timed / dt if n_timed else float("nan"))


def paired_equivalence_eval(train_model: nn.Module, inference_model: nn.Module,
                            images: np.ndarray, labels: np.ndarray, batch_size: int = 256,
                            log: Callable[[str], None] = print) -> Tuple[float, float, float, float]:
    """Accuracy and img/s of both models:
    ``(train_acc, inference_acc, train_fps, inference_fps)``."""
    acc_t, fps_t = evaluate_model(train_model, images, labels, batch_size)
    acc_i, fps_i = evaluate_model(inference_model, images, labels, batch_size)
    log(f"train-model:     acc {acc_t * 100:.2f}%  {fps_t:.1f} img/s")
    log(f"inference-model: acc {acc_i * 100:.2f}%  {fps_i:.1f} img/s")
    return acc_t, acc_i, fps_t, fps_i
