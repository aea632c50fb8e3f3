"""Closed loop, one caller: back-to-back batches through the integer
engine's one CUDA-graph bucket, cycled from a pool of distinct batches
made at set-up. A call is timed from its start on the host to its
result, a synchronize after the engine returns.

Mix parameters: ``batch``, ``pool`` (distinct batches), ``calib_steps``
and ``calib_batch`` (the calibration forwards), ``trace_calls``.
"""

from __future__ import annotations

import time

import torch

from .. import compare, harness, program, tracing, weights, work
from ..reference.iao import IaoNet


def setup(run, device):
    """The engine, the input pool and the calibration batches, from the seed."""
    tr = run.traffic
    t = time.time()
    ops = work.arch_ops(run.config)
    gen = weights.generator(run.seed, device)
    w = weights.make_weights(ops, gen, device)
    calib = weights.gaussian_images(gen, device, tr["calib_steps"], tr["calib_batch"])
    pool = weights.gaussian_images(gen, device, tr["pool"], tr["batch"])
    t = harness.phase("inputs", t)
    engine = program.calibrated_engine(run.config, w, calib, pool[0], tr["batch"], device)
    harness.phase("engine", t)
    return ops, w, calib, pool, engine


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference_logits(ops, w, calib, pool, quant: dict, stats: str, epilogue_dtype=None):
    """The reference's logits of every pool batch: calibrated on the same
    batches, then BN folded and quantized as the recipe says (with each
    layer's output rounded to ``epilogue_dtype``, where given)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = IaoNet(ops, w, quant["a_bits"], quant["w_bits"], stats=stats,
                 epilogue_dtype=epilogue_dtype)
    with torch.no_grad():
        for x in calib:
            ref(x, train=True)
        return [ref(x, train=False).float() for x in pool]


def run(run) -> None:
    device = run.device
    tr = run.traffic
    ops, w, calib, pool, engine = setup(run, device)
    n_pool = pool.shape[0]
    with torch.no_grad():
        for i in range(2):
            engine(pool[i % n_pool])
    _sync(device)
    # -- the measured window --------------------------------------------
    outputs, latency = [], []
    t0 = time.perf_counter()
    run.setup_s = time.time() - run.t_start
    deadline = t0 + run.seconds
    with torch.no_grad():
        while True:
            s = time.perf_counter()
            idx = len(outputs) % n_pool
            y = engine(pool[idx])
            _sync(device)
            e = time.perf_counter()
            outputs.append((idx, y))
            latency.append(e - s)
            if e >= deadline:
                break
    # ---------------------------------------------------------------------
    run.window = dict(kind="infer", images=len(outputs) * tr["batch"], seconds=e - t0, latency_s=latency,
                      calls=len(outputs), batch=tr["batch"])
    run.attempted = len(outputs)
    if run.trace:
        k = [0]

        def call():
            with torch.no_grad():
                engine(pool[k[0] % n_pool])
            _sync(device)
            k[0] += 1

        run.stretch = tracing.trace_stretch(call, tr["trace_calls"], device)
    if torch.device(device).type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    stats = "exact" if run.config["calibration_lowerings"]["bn_stats"] == "off" else "acc"
    ref = reference_logits(ops, w, calib, pool, run.config["quant"], stats)
    run.numbers, per_call = compare.engine_numbers(outputs, ref)
    limits = run.spec["limits"]
    run.checks = compare.checks(run.numbers, limits)
    run.failed = compare.failed_calls(per_call, limits)
