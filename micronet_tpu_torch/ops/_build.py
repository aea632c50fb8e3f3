"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Building
happens at first use (or all at once through :func:`build_all`), from the
sources in this checkout only, into ``build/kernels/`` at the repository
root. The library name carries a hash of the source and the flags, so an
edited source never loads a stale library.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass that code to :func:`check`, which raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "load", "build_all", "check", "check_operand"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("int4_matmul", "decode_attention")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register/shared-memory report, kept in the .log
]


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    running process (or None) and the target path."""
    out = _lib_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "wb")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT,
    )
    return (proc, tmp, log), out


def _finish(name: str, started, out: Path) -> None:
    proc, tmp, log = started
    rc = proc.wait()
    log.close()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        text = out.with_suffix(".log").read_text(errors="replace")
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> Dict[str, float]:
    """Compile every kernel source at once (one nvcc each, all started
    together). Returns the wall seconds of the whole build and the path
    of each library."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    for name, (st, out) in started.items():
        if st is not None:
            _finish(name, st, out)
    return {"seconds": time.perf_counter() - t0,
            **{n: str(out) for n, (_, out) in started.items()}}


@functools.lru_cache(maxsize=None)
def _cdll(name: str) -> ctypes.CDLL:
    st, out = _start(name)
    if st is not None:
        _finish(name, st, out)
    return ctypes.CDLL(str(out))


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` set for each entry point (every pointer and the stream
    as ``c_void_p``, so none is cut to 32 bits) and ``restype`` int."""
    lib = _cdll(name)
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                  shape: Optional[Tuple[int, ...]] = None, align: int = 4) -> None:
    """Raise unless ``t`` is what a kernel takes: contiguous, of ``dtype``
    (and ``shape``) on ``device``, its data ``align``-byte aligned."""
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or (shape is not None and tuple(t.shape) != tuple(shape))
            or t.data_ptr() % align):
        raise ValueError(
            f"{name}: need a contiguous, {align}-byte aligned {dtype} "
            f"{'' if shape is None else tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )
