"""CIFAR-10 input pipeline: the counterpart of ``micronet_tpu/train/data.py``.

The dataset sits in host memory as uint8 NHWC; the trainer uploads it to
the device once and gathers each batch there. Augmentation (RandomCrop 32
with padding 4, RandomHorizontalFlip, normalize with mean and std 0.5)
runs on the device for the whole batch, in two halves: the random draws
(:func:`draw_augment`, offsets and flips from a ``torch.Generator``) and
their application (:func:`apply_augment`), which does the JAX package's
f32 operations in its order.

Dataset discovery: the CIFAR-10 binary batches (through the native
loader) or the Python pickle batches, searched in ``CIFAR10_DIR``,
``./data`` and ``~/data``. With none on disk a deterministic synthetic
stand-in of CIFAR's shapes is built, byte for byte the JAX package's
(``MICRONET_SYNTHETIC_SIZE``, ``MICRONET_SYNTHETIC_NOISE``); ``source``
says which one you got.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..quant.rounding import true_div
from ..utils.profiling import span

__all__ = ["Cifar10", "load_cifar10", "normalize_batch", "draw_augment", "apply_augment",
           "augment_batch", "epoch_batches", "perm_seed"]

MEAN = np.array([0.5, 0.5, 0.5], np.float32)
STD = np.array([0.5, 0.5, 0.5], np.float32)

_SEARCH = (
    os.environ.get("CIFAR10_DIR", ""),
    "data/cifar-10-batches-py",
    os.path.expanduser("~/data/cifar-10-batches-py"),
)


@dataclass
class Cifar10:
    train_images: np.ndarray  # (N, 32, 32, 3) uint8
    train_labels: np.ndarray  # (N,) int32
    test_images: np.ndarray  # (M, 32, 32, 3) uint8
    test_labels: np.ndarray  # (M,) int32
    source: str  # "disk" | "synthetic"


def _load_pickle_batches(root: str) -> Optional[Tuple[np.ndarray, ...]]:
    try:
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        with open(os.path.join(root, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        tx, ty = d[b"data"], d[b"labels"]
    except (OSError, KeyError, pickle.UnpicklingError):
        return None
    tr_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    te_x = np.asarray(tx).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (tr_x.astype(np.uint8), np.concatenate([np.asarray(y) for y in ys]).astype(np.int32),
            te_x.astype(np.uint8), np.asarray(ty).astype(np.int32))


def _synthetic(n_train: int, n_test: int) -> Tuple[np.ndarray, ...]:
    """Deterministic class-conditional images: each class a distinct
    spatial-frequency pattern plus noise (``MICRONET_SYNTHETIC_NOISE``,
    default 0.6), so a model can fit it; a smoke signal, not a CIFAR
    result. numpy ``RandomState(0)``, as the JAX package draws it."""
    rng = np.random.RandomState(0)
    noise = float(os.environ.get("MICRONET_SYNTHETIC_NOISE", 0.6))

    def make(n):
        y = rng.randint(0, 10, size=n).astype(np.int32)
        yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
        base = np.stack([np.sin(xx * (0.2 + 0.13 * k) + yy * (0.1 * k))
                         + np.cos(yy * (0.15 + 0.11 * k)) for k in range(10)])  # (10, 32, 32)
        img = base[y][..., None].repeat(3, axis=-1)
        img = img + noise * rng.randn(n, 32, 32, 3)
        img = (img - img.min()) / (img.max() - img.min())
        return (img * 255).astype(np.uint8), y

    tr_x, tr_y = make(n_train)
    te_x, te_y = make(n_test)
    return tr_x, tr_y, te_x, te_y


def load_cifar10(synthetic_ok: bool = True, synthetic_size: Optional[int] = None) -> Cifar10:
    """CIFAR-10 from disk, else (``synthetic_ok``) the synthetic set of
    ``synthetic_size`` training images (default ``MICRONET_SYNTHETIC_SIZE``
    or 2,048) and a fifth of that (at least 256) for test."""
    if synthetic_size is None:
        synthetic_size = int(os.environ.get("MICRONET_SYNTHETIC_SIZE", 2048))
    from . import native_loader

    for root in _SEARCH:
        if not root:
            continue
        got = native_loader.load_cifar_bin(root.replace("cifar-10-batches-py",
                                                        "cifar-10-batches-bin"))
        if got is not None:
            return Cifar10(*got, source="disk")
        if os.path.isdir(root):
            got = _load_pickle_batches(root)
            if got is not None:
                return Cifar10(*got, source="disk")
    if not synthetic_ok:
        raise FileNotFoundError("cifar-10-batches-py not found in CIFAR10_DIR/./data/~/data")
    tr_x, tr_y, te_x, te_y = _synthetic(synthetic_size, max(synthetic_size // 5, 256))
    return Cifar10(tr_x, tr_y, te_x, te_y, source="synthetic")


# ------------------------------------------------------- device-side augment


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized f32 NHWC (ToTensor, Normalize(0.5, 0.5))."""
    x = true_div(images_u8.to(torch.float32), 255.0)
    mean = torch.from_numpy(MEAN).to(x.device)
    std = torch.from_numpy(STD).to(x.device)
    return (x - mean) / std


def draw_augment(gen: torch.Generator, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random half of the augmentation: crop offsets (n, 2) in 0..8
    (rows, columns) and a flip mask (n,), from ``gen`` on its device."""
    offsets = torch.randint(0, 9, (n, 2), generator=gen, device=gen.device)
    flips = torch.rand(n, generator=gen, device=gen.device) < 0.5
    return offsets, flips


def apply_augment(images_u8: torch.Tensor, offsets: torch.Tensor,
                  flips: torch.Tensor) -> torch.Tensor:
    """RandomCrop(32, padding=4) at ``offsets`` and a horizontal flip where
    ``flips``, normalized, for the whole batch: the raw uint8 image is
    padded with 0 before normalizing (padding reads -1, as torchvision's),
    then one gather takes every crop. Records the span ``train.augment``."""
    n = images_u8.shape[0]
    dev = images_u8.device
    with span("train.augment"):
        x = normalize_batch(torch.nn.functional.pad(images_u8, (0, 0, 4, 4, 4, 4)))
        offsets = offsets.to(dev)
        ar = torch.arange(32, device=dev)
        rows = (offsets[:, 0:1] + ar)[:, :, None]  # (n, 32, 1)
        cols = (offsets[:, 1:2] + ar)[:, None, :]  # (n, 1, 32)
        x = x[torch.arange(n, device=dev)[:, None, None], rows, cols]
        return torch.where(flips.to(dev)[:, None, None, None], x.flip(2), x)


def augment_batch(gen: torch.Generator, images_u8: torch.Tensor) -> torch.Tensor:
    """Draw from ``gen`` and apply: the augmentation of one training batch."""
    offsets, flips = draw_augment(gen, images_u8.shape[0])
    return apply_augment(images_u8, offsets, flips)


def perm_seed(gen: torch.Generator) -> int:
    """An epoch's permutation seed, drawn from ``gen``."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))


def epoch_batches(gen: Optional[torch.Generator], images: np.ndarray, labels: np.ndarray,
                  batch_size: int, *, shuffle: bool = True,
                  drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Host batches of one epoch: shuffled by numpy ``RandomState`` from a
    seed drawn from ``gen``, as the JAX package shuffles from its key."""
    n = images.shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(perm_seed(gen)).shuffle(idx)
    from . import native_loader

    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        j = idx[i:i + batch_size]
        if shuffle and images.dtype == np.uint8 and native_loader.available():
            yield native_loader.gather_u8(images, j), labels[j]
        else:
            yield images[j], labels[j]
