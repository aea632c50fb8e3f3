"""ctypes bindings to the native host runtime (``native/micronet_host.cpp``,
built into ``native/libmicronet_host.so`` by ``make -C native``): the
counterpart of ``micronet_tpu/train/native_loader.py``, with its own
bindings to the same unchanged library.

It gives the input pipeline a multi-threaded batch gather, a CIFAR-10
binary-format loader and the batched KL threshold search. Without the
library every function falls back to numpy (or returns None), which is
the host behaviour of the JAX package too; nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "gather_u8", "load_cifar_bin", "kl_thresholds_batch"]

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATHS = (os.path.join(_NATIVE_DIR, "libmicronet_host.so"),
              os.environ.get("MICRONET_HOST_LIB", ""))
_lib = None
_HAS_KL = False
_TRIED = False


def _ensure_built(lib_path: str) -> None:
    """(Re)build the library when it is missing or older than its source
    (it is not committed)."""
    src = os.path.join(_NATIVE_DIR, "micronet_host.cpp")
    if not os.path.exists(src):
        return
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        return
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass  # the numpy fallbacks below


def _load():
    """Open and bind the library on first use; None if it cannot be had."""
    global _lib, _HAS_KL, _TRIED
    if _TRIED:
        return _lib
    _TRIED = True
    _ensure_built(_LIB_PATHS[0])
    for path in _LIB_PATHS:
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(os.path.abspath(path))
                break
            except OSError:
                continue
    else:
        return None
    lib.mn_gather_u8.restype = ctypes.c_int
    lib.mn_gather_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.mn_load_cifar_bin.restype = ctypes.c_int
    lib.mn_load_cifar_bin.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 4
    # an older library (MICRONET_HOST_LIB) may lack the KL search
    _HAS_KL = hasattr(lib, "mn_kl_thresholds")
    if _HAS_KL:
        lib.mn_kl_thresholds.restype = ctypes.c_int
        lib.mn_kl_thresholds.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def gather_u8(src: np.ndarray, idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """``src[idx]`` over the leading axis, multi-threaded in C++ for a
    C-contiguous uint8 ``src``; numpy otherwise."""
    lib = _load()
    if lib is None or src.dtype != np.uint8 or not src.flags["C_CONTIGUOUS"]:
        return src[idx]
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    item = int(np.prod(src.shape[1:]))
    dst = np.empty((idx.shape[0],) + src.shape[1:], np.uint8)
    rc = lib.mn_gather_u8(src.ctypes.data, src.shape[0], idx.ctypes.data, idx.shape[0], item,
                          dst.ctypes.data, n_threads)
    if rc != 0:
        raise RuntimeError(f"mn_gather_u8 failed (rc={rc})")
    return dst


def kl_thresholds_batch(counts: np.ndarray, absmax: np.ndarray,
                        num_quantized_bins: int = 128) -> Optional[np.ndarray]:
    """The KL threshold of each histogram row, searched in parallel in C++;
    None without the library (the caller runs ``kl_threshold``)."""
    lib = _load()
    if lib is None or not _HAS_KL:
        return None
    counts = np.ascontiguousarray(counts, np.float64)
    absmax = np.ascontiguousarray(absmax, np.float64)
    n, bins = counts.shape
    out = np.empty((n,), np.float64)
    rc = lib.mn_kl_thresholds(counts.ctypes.data, absmax.ctypes.data, n, bins,
                              num_quantized_bins, out.ctypes.data, 0)
    return out if rc == 0 else None


def load_cifar_bin(root: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """cifar-10-batches-bin through the native parser; None if absent."""
    lib = _load()
    if lib is None or not os.path.isdir(root):
        return None
    tr_x = np.empty((50000, 32, 32, 3), np.uint8)
    tr_y = np.empty((50000,), np.uint8)
    te_x = np.empty((10000, 32, 32, 3), np.uint8)
    te_y = np.empty((10000,), np.uint8)
    rc = lib.mn_load_cifar_bin(root.encode(), tr_x.ctypes.data, tr_y.ctypes.data,
                               te_x.ctypes.data, te_y.ctypes.data)
    if rc != 0:
        return None
    return tr_x, tr_y.astype(np.int32), te_x, te_y.astype(np.int32)
