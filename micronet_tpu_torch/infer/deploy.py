"""Deployment: batch-bucket engines on CUDA graphs and serialized
``torch.export`` programs: the counterpart of
``micronet_tpu/infer/deploy.py`` (the reference's TensorRT deploy
utilities, ``deploy/tensorrt/util_trt.py``).

- ``get_engine``'s fixed-shape path and its optimization profile
  (min/opt/max) -> :func:`build_engine`: a set of batch BUCKETS.
  :class:`CompiledEngine` captures one CUDA graph per bucket at
  construction (the JAX package compiles each bucket ahead of time), with
  a static input and output per bucket; a request goes to the smallest
  covering bucket, its tail padded with zeros, and a batch beyond the
  largest bucket runs in chunks of it. A replay makes no Python call and
  launches every kernel the eager forward launched, so the engine's host
  time per forward is one copy in, one replay and one copy out. The copy
  out goes into a block of ``RESULT_BLOCK_BYTES`` that many calls'
  results share (:class:`ResultBlocks`). On the
  CPU (no graphs) each bucket runs the module eagerly with the same
  padding and chunking. A call records the spans (``utils/profiling.py``)
  ``engine.call`` and, per bucket run, ``engine.copy_in``,
  ``engine.replay`` (the eager forward without a graph) and
  ``engine.copy_out``.
- engine serialization -> :func:`serialize_engine` /
  :func:`deserialize_engine` on ``torch.export`` programs (``.pt2``) with
  the weights embedded. The engine's hand-written kernels are registered
  operators (each defined by ``ops/_build.py::operator`` in its module
  under ``ops/``; importing ``ops`` registers them all), so the exported
  graph calls them. An artifact
  records the device type it was exported on and, for CUDA, the card's
  name and compute capability, and refuses to load elsewhere, as a JAX
  artifact refuses another platform.

- sharded serving (``mesh=``, a ``parallel.make_mesh`` mesh; one process
  per card, each building the same engine): the engine's state is
  channel-sharded over the ``model`` axis (``parallel.shard_state``),
  buckets round up to a multiple of the ``data`` axis, and every rank is
  called with the same global batch, runs its rows and returns the whole
  output (gathered over ``data``), as the JAX engine returns a global
  array. On the card each bucket is still one CUDA graph at the rank's
  rows, with the channel gathers captured inside it where NCCL carries
  them; gloo collectives cannot be captured, so over gloo a
  channel-sharded engine runs its buckets eagerly. The gather of the
  output rows stays outside the graph.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import zipfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..nn.modules import eval_mode
from .. import ops  # noqa: F401  (registers the engine's operators)
from ..parallel.distributed import _gather_parts
from ..parallel.sharding import axis_size, check_mesh, shard_batch, shard_state
from ..utils.profiling import span
from .engine import _no_tf32

__all__ = [
    "CompiledEngine",
    "build_engine",
    "serialize_engine",
    "deserialize_engine",
]

# the artifact's record of the device it was exported for (an extra file of the .pt2)
RECORD = "micronet_tpu_torch_engine.json"
# the block a replayed call's result is cut from (ResultBlocks), and each
# result's alignment in it
RESULT_BLOCK_BYTES = 8 << 20
RESULT_ALIGN_BYTES = 128


class ResultBlocks:
    """New tensors cut from shared blocks of :data:`RESULT_BLOCK_BYTES`.

    :meth:`take` returns a copy of a tensor, a view of the current block,
    and allocates a new block only when that one is full. A caller that
    keeps every result on the card (a batch job gathering its outputs)
    then grows PyTorch's caching allocator by one large block every few
    hundred calls. With a fresh tensor a call (``clone``), results under
    1 MB come from 2 MB segments, and such a caller makes a ``cudaMalloc``
    every few dozen calls: measured on an H100 with MobileNetV2's engine
    at batch 1,024 (40 KB results, 12 ms calls), 27 of them in 20 s, some
    of which held the host 20 to 110 ms with the card idle. A result
    keeps its whole block alive; a caller that drops its results lets the
    allocator reuse the blocks."""

    def __init__(self):
        self._block: Optional[torch.Tensor] = None
        self._used = 0

    def take(self, y: torch.Tensor) -> torch.Tensor:
        """A new tensor equal to ``y`` (same shape, dtype and device),
        contiguous, in the current block."""
        n, block = y.numel(), self._block
        if (block is None or block.dtype != y.dtype or block.device != y.device
                or self._used + n > block.numel()):
            block = self._block = torch.empty(max(n, RESULT_BLOCK_BYTES // y.element_size()),
                                              dtype=y.dtype, device=y.device)
            self._used = 0
        out = block[self._used:self._used + n].view(y.shape)
        out.copy_(y)
        align = RESULT_ALIGN_BYTES // y.element_size()
        self._used += -(-n // align) * align
        return out


def profile_buckets(min_batch: int, max_batch: int) -> Tuple[int, ...]:
    """Geometric (x2) bucket ladder covering [min_batch, max_batch]: every
    request in range wastes < 50% padding, and each bucket is one
    captured graph."""
    buckets = []
    b = max(int(min_batch), 1)
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_batch))
    return tuple(dict.fromkeys(buckets))


def _model_device(model: nn.Module) -> torch.device:
    for t in itertools.chain(model.parameters(), model.buffers()):
        return t.device
    raise ValueError("the model holds no parameter or buffer to take its device from")


def _register_flop_formulas() -> None:
    """2 * M * K * N for K1, K2 and ``torch._int_mm``, where
    ``FlopCounterMode`` has no formula of its own."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    def matmul_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
        m, k = x_shape
        return 2 * m * k * w_shape[1]

    for op in (torch.ops.micronet_tpu_torch.int8_matmul_dequant,
               torch.ops.micronet_tpu_torch.binary_act_matmul, torch.ops.aten._int_mm):
        if op not in flop_registry:
            register_flop_formula(op)(matmul_flops)


class CompiledEngine:
    """Batch-bucket inference engine: one CUDA graph per bucket on the card.

    ``model`` is any eval-mode module (typically a frozen int engine) on
    ``device`` (CUDA by default, which raises without a card). On the card
    every bucket's graph is captured at construction, after two warm-up
    forwards on a side stream (which build the kernels and the engine's
    kept GEMM weights outside the capture); a capture that fails raises.
    Calls pick the smallest covering bucket; oversized batches run in
    largest-bucket chunks; the padded tail rows are sliced away. Each call
    returns a new tensor (a replay overwrites its bucket's static output):
    a replay's result is copied into a block shared with later calls'
    results (:class:`ResultBlocks`).
    With ``mesh`` (module docstring) the model is sharded in place and a
    bucket's graph runs the rank's rows of it.
    """

    def __init__(
        self,
        model: nn.Module,
        buckets: Sequence[int],
        example_shape: Tuple[int, ...],
        dtype=torch.float32,
        mesh=None,
        device=None,
    ):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        if mesh is not None:
            check_mesh(mesh)
        dev, self.device = resolve_device(device), _model_device(model)
        if self.device.type != dev.type:
            raise ValueError(f"the model lives on {self.device}, not on {dev}")
        self.model = eval_mode(model)
        self.mesh = mesh
        self._data = 1
        capture = self.device.type == "cuda"
        if mesh is not None:
            shard_state(self.model, mesh)
            self._data = axis_size(mesh, "data")
            buckets = [-(-int(b) // self._data) * self._data for b in buckets]
            capture = capture and (axis_size(mesh, "model") == 1
                                   or torch.distributed.get_backend() == "nccl")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.example_shape = tuple(example_shape)
        self.dtype = dtype
        self._flops: Optional[Dict[int, float]] = None
        # bucket -> (graph, static input, static output), on the card only
        self._graphs = {}
        self._results = ResultBlocks()
        if capture:
            for b in self.buckets:
                x = torch.zeros((b // self._data, *self.example_shape), dtype=dtype,
                                device=self.device)
                self._warm(x)
                self._graphs[b] = self._capture(x)

    @torch.no_grad()
    def _warm(self, x: torch.Tensor) -> None:
        """Two forwards on a side stream, as ``torch.cuda.graphs`` asks:
        the kernels build and the engine keeps its GEMM weights outside
        the capture."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(2):
                self.model(x)
        main.wait_stream(side)

    @torch.no_grad()
    def _capture(self, x: torch.Tensor):
        """One forward on the static input ``x`` captured into a graph:
        (graph, static input, static output)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = self.model(x)
        return graph, x, y

    def _run_bucket(self, b: int, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if self.mesh is not None:
            # the rank's rows of the padded bucket, then every rank's output
            if n < b:
                x = torch.cat([x, x.new_zeros((b - n, *self.example_shape))])
            y = self._run_rows(b, shard_batch(x, self.mesh))
            return torch.cat(_gather_parts(y, self.mesh.get_group("data")))[:n]
        return self._run_rows(b, x)

    def _run_rows(self, b: int, x: torch.Tensor) -> torch.Tensor:
        """The first ``len(x)`` rows of bucket ``b``'s forward (on this rank:
        ``b`` over the data axis rows), zeros padding the rest."""
        n, rows = x.shape[0], b // self._data
        if b in self._graphs:
            graph, sx, sy = self._graphs[b]
            with span("engine.copy_in"):
                sx[:n].copy_(x)
                if n < rows:
                    sx[n:].zero_()
            with span("engine.replay"):
                graph.replay()
            with span("engine.copy_out"):
                return self._results.take(sy[:n])
        with span("engine.copy_in"):
            if n < rows:
                x = torch.cat([x, x.new_zeros((rows - n, *self.example_shape))])
        with span("engine.replay"), torch.no_grad():
            y = self.model(x)
        with span("engine.copy_out"):
            return y[:n]

    def __call__(self, x) -> torch.Tensor:
        with span("engine.call"):
            x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            n = x.shape[0]
            covering = [b for b in self.buckets if b >= n]
            if covering:
                return self._run_bucket(covering[0], x)
            # beyond the profile max: chunk through the largest bucket
            big = self.buckets[-1]
            return torch.cat([self._run_bucket(big, x[i:i + big]) for i in range(0, n, big)])

    @property
    def flops(self) -> dict:
        """Per-bucket operation counts of one forward, from
        ``torch.utils.flop_counter.FlopCounterMode`` over an eager forward
        on zeros (on the card that forward launches the kernels); under a
        mesh, this rank's forward of its rows."""
        if self._flops is None:
            from torch.utils.flop_counter import FlopCounterMode

            _register_flop_formulas()
            self._flops = {}
            for b in self.buckets:
                x = torch.zeros((b // self._data, *self.example_shape), dtype=self.dtype,
                                device=self.device)
                with torch.no_grad(), FlopCounterMode(display=False) as counter:
                    self.model(x)
                self._flops[b] = float(counter.get_total_flops())
        return dict(self._flops)


def build_engine(
    model: nn.Module,
    profile: Tuple[int, int, int] = (1, 32, 256),
    example_shape: Tuple[int, ...] = (32, 32, 3),
    dtype=torch.float32,
    mesh=None,
    device=None,
) -> CompiledEngine:
    """TRT ``get_engine`` analog: profile = (min, opt, max) batch. ``opt``
    is guaranteed its own exact bucket; min/max bound the ladder; ``mesh``
    shards it (:class:`CompiledEngine`)."""
    lo, opt, hi = profile
    buckets = sorted(set(profile_buckets(lo, hi)) | {int(opt)})
    return CompiledEngine(model, buckets, example_shape, dtype, mesh=mesh, device=device)


def serialize_engine(
    model: nn.Module,
    batch: int,
    example_shape: Tuple[int, ...] = (32, 32, 3),
    dtype=torch.float32,
    path: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize the engine at one batch to a ``torch.export`` artifact
    (``.pt2``) with the weights embedded: the ``engine.serialize()`` +
    ``open(...,"wb").write`` flow of util_trt.py:60-67. ``platforms``
    names the one device type to export on, ``("cuda",)`` (the default,
    which raises without a card) or ``("cpu",)``; the model must live
    there. The export is non-strict (the Python forward runs on fake
    tensors)."""
    plats = ("cuda",) if platforms is None else tuple(platforms)
    if len(plats) != 1 or plats[0] not in ("cuda", "cpu"):
        raise ValueError(f"platforms must name one of 'cuda' or 'cpu', got {plats}")
    dev = resolve_device(plats[0])
    mdev = _model_device(model)
    if mdev.type != dev.type:
        raise ValueError(f"the model lives on {mdev}: move it to {dev.type} to export there")
    eval_mode(model)
    x = torch.zeros((batch, *example_shape), dtype=dtype, device=mdev)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
    # the zeros it was traced on would be saved with it (6.3 MB at batch 512)
    program.example_inputs = None
    record = dict(device_type=mdev.type, batch=int(batch), example_shape=list(example_shape),
                  dtype=str(dtype))
    if mdev.type == "cuda":
        record.update(name=torch.cuda.get_device_name(mdev),
                      capability=list(torch.cuda.get_device_capability(mdev)))
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={RECORD: json.dumps(record)})
    data = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


def artifact_record(data: bytes) -> dict:
    """The device record of an artifact's bytes, read without loading its
    program."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = [n for n in z.namelist() if n.endswith(f"extra/{RECORD}")]
        if not names:
            raise ValueError("not an engine artifact of micronet_tpu_torch: no device record")
        return json.loads(z.read(names[0]))


def _check_record(rec: dict) -> None:
    """Raise unless this machine is the device type (and, for CUDA, the
    compute capability) the artifact was exported for."""
    kind = rec.get("device_type")
    if kind == "cpu":
        return
    if kind != "cuda":
        raise RuntimeError(f"the artifact was exported for device type {kind!r}, not cuda or cpu")
    cap = tuple(rec.get("capability", ()))
    want = f"{rec.get('name')} (sm_{''.join(map(str, cap))})"
    if not torch.cuda.is_available():
        raise RuntimeError(f"the artifact was exported for CUDA on {want}; this machine has no "
                           "CUDA card")
    have = tuple(torch.cuda.get_device_capability())
    if have != cap:
        raise RuntimeError(f"the artifact was exported for {want}; this card, "
                           f"{torch.cuda.get_device_name()}, is sm_{''.join(map(str, have))}")


def deserialize_engine(data_or_path) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load a serialized engine back into a callable
    (``runtime.deserialize_cuda_engine``, util_trt.py:99-116). The
    engine's operators are registered by this module's imports before the
    program loads. The program runs under ``torch.no_grad`` with TF32 off for
    matmuls and cuDNN (the flags the engine's first layer sets, which an
    exported graph does not carry). The callable's ``program`` is the
    loaded ``ExportedProgram``."""
    if isinstance(data_or_path, (str, os.PathLike)):
        with open(data_or_path, "rb") as f:
            data = f.read()
    else:
        data = bytes(data_or_path)
    _check_record(artifact_record(data))
    program = torch.export.load(io.BytesIO(data))
    module = program.module()

    def run(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _no_tf32():
            return module(x)

    run.program = program
    return run
