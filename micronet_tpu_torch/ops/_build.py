"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Building
happens at first use (or all at once through :func:`build_all`), from the
sources in this checkout only, into ``build/kernels/`` at the repository
root. The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``), the flags and any macros defined for a diagnostic build,
so an edited source never loads a stale library.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass that code to :func:`check`, which raises on anything but 0.
A C entry point launches on the current card, so each wrapper makes its
tensors' card current around the call (:func:`on_card`); :func:`launch`
does both around one call on the current stream.

The integer engine's kernels are registered PyTorch operators, each
defined once through :func:`operator` on the namespace
``torch.ops.micronet_tpu_torch``, so that eager code, a captured CUDA
graph and a ``torch.export`` program reach the same kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .._device import on_cuda

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "load", "build_all", "check", "check_operand",
           "sm_count", "on_card", "launch", "operator"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
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


def _flags(defines: Tuple[str, ...]) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str, defines: Tuple[str, ...] = ()):
    """Start nvcc for ``name`` (with the macros ``defines``) unless its
    library exists; returns the running process (or None) and the target
    path."""
    out = _lib_path(name, defines)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "wb")
    proc = subprocess.Popen(
        [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")],
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
def _cdll(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    st, out = _start(name, defines)
    if st is not None:
        _finish(name, st, out)
    return ctypes.CDLL(str(out))


def load(name: str, signatures: Dict[str, List],
         defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed (with the macros
    ``defines``, for a diagnostic build), with ``argtypes`` set for each
    entry point (every pointer and the stream as ``c_void_p``, so none is
    cut to 32 bits) and ``restype`` int. Binding happens once per library;
    later calls cost a cache lookup."""
    lib = _cdll(name, tuple(defines))
    if "bound" not in vars(lib):
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's number of SMs, read once per card."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def on_card(device: torch.device):
    """A context in which ``device`` is the current card, for a launch
    through ctypes (which runs on the current card whatever its pointers'
    card). Nothing is entered when it is current already, so a decode
    step on one card pays only the query."""
    if device.index is None or torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(entry, device: torch.device, what: str, *args) -> None:
    """Call the C entry point ``entry(*args, stream)`` on ``device``'s
    current stream with ``device`` the current card, and raise if it
    reports a CUDA error."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    with on_card(device):
        rc = entry(*args, stream)
    check(rc, what)


# torch.ops.micronet_tpu_torch. A plain library definition: torch.library.custom_op checks its
# inputs' aliasing on every call, 0.014 to 0.031 ms more host time a call than the launch alone on
# an H100 (chip_smoke.py phase 19), against K1's 0.007 ms of device time
_LIB = torch.library.Library("micronet_tpu_torch", "DEF")


def operator(schema: str, card: Callable, twin: Callable, fake: Callable, counted: Callable):
    """Define the operator ``torch.ops.micronet_tpu_torch.<name>`` of
    ``schema`` (``"name(arguments) -> Tensor"``) and return its
    ``.default`` overload. Its one implementation, for every device, runs
    ``twin`` on a CPU tensor and ``card`` (the hand-written kernel) on a
    CUDA tensor, the device that of the first argument; ``fake`` gives the
    output's shape and dtype for tracing. All three take the schema's
    arguments in order. ``counted``, the public wrapper, gets a
    ``launches`` that counts the operator's runs on a CUDA tensor (a
    Python call each): a CUDA graph's replay makes no Python call and
    counts nothing."""
    name = schema[:schema.index("(")]

    def impl(*args):
        if not on_cuda(args[0]):
            return twin(*args)
        out = card(*args)
        counted.launches += 1
        return out

    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    torch.library.register_fake(f"micronet_tpu_torch::{name}", fake, lib=_LIB)
    counted.launches = 0
    return getattr(torch.ops.micronet_tpu_torch, name).default


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
