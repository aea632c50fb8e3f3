#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``micronet_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--profile] [--out DIR]

Phases, each fatal on failure (non-zero exit, no final line):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: every kernel of the serving path, from ``ops/csrc/`` (one
   ``nvcc`` per source, all started together);
3. kernels: each hand-written kernel against its plain PyTorch twin on
   the card at the shapes the W4 Llama-3-8B serving path gives it, with
   its time (CUDA events), the twin's, one PyTorch library call's
   (timed here only; the port never calls it) and the least time the
   card could take (bytes at 3.35 TB/s, or bf16 operations at
   989 TFLOP/s). K3 runs at M = 1, 8 and 128 (regime A, decode) and at
   M = 6,000 (regime B, the long prompt's prefill; held against the twin
   on 64 sampled rows); its device times come in phase 12; its
   kernels-line row is a decode step's 129 calls at M = 8, with the 129
   calls at M = 6,000 as ``prefill_*``. K4a and K5a run at G = 64, R = 4,
   D = 128, S = 2,048 with bounds 1..2,048, and K4a again at the serving
   loop's fills (bounds 16..288, its row's ``fills_*``); how many clusters
   of the decode-attention kernel the card holds at once;
4. reference: a small Llama with head_dim 128 served on the card and on
   the CPU (where the wrappers run their twins), logits compared;
5. serve (slice 1's main path): ``Llama(llama3_8b(2048), w4_group=128)`` with
   random weights from a seeded generator, 12 greedy requests through
   ``ServeLoop(max_slots=8)``, then one request again through
   ``Llama.generate`` alone, which must give the same tokens; the
   kernels' launch counts, reset just before and read just after, must
   show every kernel ran as often as the path calls it;
6. with ``--profile``, a traced run of 5 decode steps at 8 busy slots
   (``torch.profiler``): device busy share and kernel time by name (and
   the same for 3 forwards of each engine in phases 9 and 13, and for both
   loops of phase 11);
7. K1 (``int8_matmul_dequant``) against its twin, bit for bit, at the
   engine's call, a large call and a ragged A4 call with zp != 0: the
   public wrapper in the regime ``_k1_regime`` picks (logged) and each of
   its two regimes forced (the small mma.sync kernel, the wgmma GEMM with
   its pre-passes), timed beside ``torch._int_mm`` on codes and its int8
   bound (1,979 TOP/s); its device times come at the end of phase 12;
8. conv routes: every IntConv2d route at ResNet-18's and NIN-GC's layer
   shapes; the int32 accumulators equal an f64 conv of the same codes;
9. engine (slice 2's main path): ``resnet18()`` with seeded random
   weights, ``prepare`` W8A8 with fused BN, 4 calibration forwards at
   batch 64, ``fuse_bn_iao``, ``freeze_int``, engine forwards at batch
   512; K1 must launch once per forward (counts zeroed just before, read
   just after); the same engine on the CPU must agree on 8 images;
   img/s of the engine and of the port's fp32 eval. Then the same for
   NIN-GC W4A4 at batch 1024 (no kernel on that path);
10. long-context kernels: K4b and K5b (the blocked wrappers; the cluster
   regime at S = 8192) against their twins at G = 64, R = 4, D = 128,
   S = 8192 with bounds 0..8192; K4b at bound b equal to K5b at b + 1 bit
   for bit; K6 and K7 over shuffled pools of pages of 16 and 512 against
   their twins and, bit for bit, against the dense kernel over the
   gathered view; times beside the twins', SDPA's and the bound;
11. paged and long-context serving (slice 3's main path):
   ``Llama(llama3_8b(8192), w4_group=128)``, 12 greedy requests (two of
   4,500 and 6,000 prompt tokens) through the dense ``ServeLoop(8)`` (K4b
   every decode step) and the paged ``ServeLoop(8, paged=True,
   page_size=16)`` (K6) with a pool smaller than the first eight requests
   reserve (admission must defer), then the 6,000-token request alone
   through ``Llama.generate`` (K5b): equal tokens everywhere, every page
   back, exact launch counts; each loop's prefill seconds, the 6,000-token
   prompt's own among them;
12. wbwtab kernels: K2 (``binary_act_matmul``) against its twin, bit for
   bit, in the regime picked and in both forced, at NIN-GC's largest
   ternary 1x1 conv as a dense GEMM (batch 1024: M = 65,536, K = N =
   1,024), a ragged call and a call with exact zeros, -0.0 and NaN in x,
   timed beside ``torch._int_mm`` on sign codes made beforehand; K8 (``int4_matmul``) and K9 (``int4_matmul_grouped``, group
   128) at the five Llama-3-8B shapes of phase 3, M = 1, 8 and 128, within
   K3's tolerance, timed beside ``torch.matmul`` on the dequantized bf16
   weight, each also by its device time alone (``torch.profiler``); the
   kernels line's times are a decode step's 129 calls at M = 8, its
   ``max_abs_err`` the largest over every M; then K3's device time at
   phase 3's shapes, M = 8 and 6,000, beside ``torch.matmul``'s, and the
   device times of K4a (phase 3's bounds and the serving fills), K4b and
   K6 (pages of 16) at phase 3's and 10's shapes, then K1's at phase 7's
   three calls and K2's at its path call (the wrapper and each regime
   forced) beside ``torch._int_mm``'s on codes (after the serving
   phases, so that no profiler session runs before those; a trace that
   lost kernels is taken again with longer quiet pads around the calls,
   and is fatal after five);
13. wbwtab engine (slice 4's main path): ``nin_gc.Net()`` at full width
   with seeded random weights, ``prepare(method="wbwtab")`` at W = 3 and
   W = 2 (A = 2), 4 train-mode forwards at batch 64 for the BN
   statistics, ``fuse_bn_wbwtab``, ``freeze_wbwtab`` (7 ``TernaryConv2d``),
   engine forwards at batch 1024 (no hand-written kernel on this path: every
   count zeroed just before and still 0 just after); img/s beside the
   port's fp32 eval and the fused float model; on 8 images the first
   block's pre-sign output on the card against the CPU, then the rest of
   the engine from the same signs on both, bit for bit;
14. the kernels line (JSON), then the final line
   ``{"ok": true, "device": {...}}``.

Details of every measurement go to ``<out>/chip_smoke.json`` (``--out``,
default ``build/chip_smoke``).
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
L2_BYTES = 50 * 2**20
GROUP = 128
# (K, N) of each W4 projection of one Llama-3-8B block, and the lm_head,
# with how many times one decode step calls it
K3_SHAPES = [((4096, 6144), 32), ((4096, 4096), 32), ((4096, 28672), 32),
             ((14336, 4096), 32), ((4096, 128256), 1)]
K3_MS = (1, 8, 128)  # regime A (decode)
K3_PREFILL_M = 6000  # regime B: the long prompt of phase 11 (LONG_PROMPTS[0])
K3_TWIN_COLS = 16384  # the twin on sampled rows, this many columns at a time
ATT_G, ATT_R, ATT_D, ATT_S = 64, 4, 128, 2048  # 8 slots x 8 KV heads
# the bounds of phase 5's decode steps: prompts of 16 to 256 tokens plus up to 32 new ones
SERVE_FILLS = (16, 288)
# exact products, f32 sums in another order over up to 14336 terms
K3_REL_TOL = 2e-5
# sums in another order; a term p * v_scale within an ulp of a bf16
# rounding boundary may round to the neighbouring bf16 value
ATT_ABS_TOL = 1e-3
# the long-context phase (S = 8192, outputs of about 1e-2): the same cause,
# measured at 9e-6 to 1.4e-5 on the card; about 7x that
LONG_ATT_TOL = 1e-4
# logits of a whole model: an activation may cross a bf16 rounding
# boundary before a W4 matmul (2^-8 relative on that term)
MODEL_REL_TOL = 1e-2
N_REQUESTS, SLOTS, NEW_TOKENS = 12, 8, 32
# slice 3: Llama-3-8B at its published context (max_position_embeddings)
LONG_CTX = 8192
LONG_PROMPTS = (6000, 4500)  # requests 0 and 7
SHORT_PROMPTS = (16, 512)  # the other ten, drawn from this range
PAGE, PAGES_E2E = 16, 512  # the loop's page size; benchmarks/llm_paged_e2e.py's
LONG_KERNELS = ("decode_attend_q8kv_blocked_cur", "decode_attend_q8kv_blocked",
                "paged_decode_attend_cur", "paged_decode_attend")
# slice 4: on no path of the JAX package; counted over the wbwtab engine's run
WBWTAB_KERNELS = ("binary_act_matmul", "int4_matmul", "int4_matmul_grouped")
# K1 calls: (label, M, K, N, s_x, zp, qmin, qmax, timed launches). "path" is
# ResNet-18's fc at the engine batch of 512
K1_CASES = [
    ("path", 512, 512, 10, 0.05, 0.0, -128.0, 127.0, 200),
    ("large", 8192, 4096, 4096, 0.05, 0.0, -128.0, 127.0, 10),
    ("ragged A4 zp", 333, 200, 19, 0.5, 3.0, -8.0, 7.0, 100),
]
# IntConv2d layer shapes (cin, size, cout, kernel, stride, padding, groups):
# every distinct conv of ResNet-18 and of NIN-GC's default widths
RESNET_CONVS = [(3, 32, 64, 3, 1, 1, 1), (64, 32, 64, 3, 1, 1, 1), (64, 32, 128, 3, 2, 1, 1),
                (128, 16, 128, 3, 1, 1, 1), (64, 32, 128, 1, 2, 0, 1),
                (128, 16, 256, 3, 2, 1, 1), (256, 8, 256, 3, 1, 1, 1),
                (128, 16, 256, 1, 2, 0, 1), (256, 8, 512, 3, 2, 1, 1),
                (512, 4, 512, 3, 1, 1, 1), (256, 8, 512, 1, 2, 0, 1)]
NIN_CONVS = [(3, 32, 256, 5, 1, 2, 1), (256, 32, 256, 1, 1, 0, 2), (256, 16, 512, 3, 1, 1, 16),
             (512, 16, 512, 1, 1, 0, 4), (512, 8, 1024, 3, 1, 1, 32),
             (1024, 8, 1024, 1, 1, 0, 8), (1024, 8, 10, 1, 1, 0, 1)]
ROUTE_BATCH = 16
# the first layer's f32 sums of at most 75 products: ~1e-6 relative; TF32
# operands (10-bit mantissas) would miss by ~1e-3
F32_ROUTE_RTOL = 1e-5
# engine paths: bench.py's configurations, ResNet-18 W8A8 at batch 512 and
# NIN-GC W4A4 at batch 1024; calibration of 4 forwards at batch 64
RESNET_BATCH, NIN_BATCH = 512, 1024
CALIB_STEPS, CALIB_BATCH, ENGINE_ITERS, CPU_BATCH = 4, 64, 10, 8
# Card vs CPU engine logits, relative to max(1, max|logit|): the integer
# convolutions are exact on both; the first layer's f32 sums run in
# another order, so a chained code there may move one step at a .5
# boundary, and the change reaches the logits damped by later layers.
CARD_CPU_TOL = 2e-2
# engine vs the fake-quant model it was frozen from: the JAX package's own
# bound (tests/test_resnet_quant.py, atol 0.1): the fake-quant model sums
# dequantized values in f32, so codes at .5 boundaries move in many layers
FQ_TOL = 0.1
# K2 calls: (label, M, K, N, timed launches). "path" is NIN-GC's largest
# ternary 1x1 conv (the 8th, 1024 -> 1024 at 8 x 8) as a dense GEMM at the
# engine batch of 1024; "zeros" holds exact zeros, -0.0 and NaN in x
K2_CASES = [("path", NIN_BATCH * 64, 1024, 1024, 10), ("ragged", 333, 200, 19, 100),
            ("zeros", 1000, 512, 256, 100)]
WO_MS = (1, 8, 128)  # K8 and K9 at the shapes of K3_SHAPES
# K8/K9 against their twins: K3's bound (exact products, f32 sums in
# another order over up to 14,336 terms, tensor-core accumulation
# included), relative to max|twin|; measured on an H100 at the five 8B
# shapes: at most 5.8e-6 at M = 1 and 8 and 1.4e-5 at M = 128, on outputs
# up to ~15: under 1.3e-6 relative
WO_REL_TOL = K3_REL_TOL
# the wbwtab engine's first block: an f32 conv of 75 products per output,
# summed in another order on the card and the CPU (as F32_ROUTE_RTOL);
# from the same signs on, the engine's convs are exact on both
WBWTAB_W = (3, 2)
# the float classifier (a 1x1 conv over 1,024 signs) and the average pool
# after the last ternary layer: f32 sums in another order, relative to
# max(1, max|logit|)
CLASSIFIER_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, args_list, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn(*args)`` over ``iters`` launches, cycling through
    ``args_list`` (copies of the inputs larger than L2 together, so each
    launch finds its weights cold, as a decode step does)."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the quiet time (s) before and after the calls in each torch.profiler trace of device_ms:
# one per attempt
TRACE_PADS = (0.01, 0.03, 0.1, 0.3, 1.0)
# device_ms readings that needed more than one trace
TRACE_RETRIES = []


def device_ms(fn, args_list, iters: int, per_call: int = 1) -> float:
    """Mean device time (ms) of the kernels one ``fn(*args)`` launches,
    from ``torch.profiler`` over ``iters`` calls: no host time, unlike
    :func:`time_ms`, which measures back-to-back calls and so the host
    where a call's host work outlasts its kernels. Each call launches the
    same kernels, at least ``per_call`` of them, so a trace is whole only
    if it holds at least ``iters * per_call`` kernels and each kernel name
    a multiple of ``iters`` times. Traces have lost kernels on an H100
    (fewer kernels than calls, or none), more often the longer the process
    had used the profiler; the cause is not isolated. A kernel whose
    timestamp drifts outside the trace's window would be dropped, so the
    card sits idle for a pad before and after the calls, longer at each
    attempt (``TRACE_PADS``); a trace still not whole after the last is
    fatal."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = getattr(fn, "__name__", str(fn))
    fn(*args_list[0])
    torch.cuda.synchronize()
    for attempt, pad in enumerate(TRACE_PADS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
            time.sleep(pad)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts = Counter(e.name for e in kernels)
        if len(kernels) >= iters * per_call and all(c % iters == 0 for c in counts.values()):
            if attempt:
                TRACE_RETRIES.append(dict(fn=name, iters=iters, attempts=attempt + 1, pad_s=pad))
            return sum(e.self_device_time_total for e in kernels) / 1e3 / iters
        span = (f"{min(e.time_range.start for e in kernels):.0f} to "
                f"{max(e.time_range.end for e in kernels):.0f} us" if kernels else "none")
        log(f"device_ms {name}: trace {attempt + 1} (pads of {pad} s) held {len(kernels)} "
            f"kernels for {iters} calls of at least {per_call} ({dict(counts)}), at {span}")
    fail(f"torch.profiler recorded fewer kernels than {iters} calls of {name} launch, in "
         f"{len(TRACE_PADS)} traces")


def copies_for(nbytes: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


# ---------------------------------------------------------------- phase 3


def _k3_bound(m, k, n):
    """K3's least time (ms) for one call and what sets it: x read, the packed
    weights and scales read, the output written once; 2MKN bf16 operations."""
    nbytes = m * k * 4 + k // 2 * n + k // GROUP * n * 4 + m * n * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _k3_weights(k, n, dev, gen):
    """Copies of one shape's hl8 weights and group scales, larger than L2
    together, and as many bf16 dequantized copies for ``torch.matmul``."""
    from micronet_tpu_torch.ops import int4_matmul as im

    weights = []
    for _ in range(copies_for(k // 2 * n + k // GROUP * n * 4)):
        packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=dev,
                               generator=gen)
        gs = torch.rand((k // GROUP, n), device=dev, generator=gen) * 0.01 + 1e-3
        weights.append((packed, gs))
    w_bf16 = [(im.unpack_int4_hl8(p).float() * im.expand_gscale(g, GROUP)).to(torch.bfloat16)
              for p, g in weights[: copies_for(2 * k * n)]]
    return weights, w_bf16


def _k3_calls(m, x, weights, w_bf16):
    """K3's and ``torch.matmul``'s argument lists at M = m, and the calls a
    reading takes: at M <= 128 30 calls over every copy, so each finds its
    weights cold in L2; at the prefill's M a few calls on one copy."""
    xb = x.to(torch.bfloat16)
    if m == K3_PREFILL_M:
        return [(x, *weights[0])], [(xb, w_bf16[0])], 3
    return [(x, p, g) for p, g in weights], [(xb, w) for w in w_bf16], 30


def check_k3(dev, gen, report):
    """K3 at the five W4 shapes of one Llama-3-8B forward: M = 1, 8 and 128
    (regime A, decode) against the whole twin, weights cold in L2; M = 6,000
    (regime B, the long prompt's prefill) against the twin on a sample of
    rows (the first, the last and 62 drawn from ``gen``) in column chunks,
    since the whole twin would hold (K/g, M, N) f32. Each beside
    ``torch.matmul`` on the dequantized bf16 weight, by events; the device
    times come later, from :func:`k3_device_times`."""
    from micronet_tpu_torch.ops import int4_matmul as im

    cases = {}
    for (k, n), per_step in K3_SHAPES:
        weights, w_bf16 = _k3_weights(k, n, dev, gen)
        for m in K3_MS + (K3_PREFILL_M,):
            x = torch.randn((m, k), device=dev, generator=gen)
            out = im.int4_matmul_grouped_hl8(x, *weights[0])
            if m == K3_PREFILL_M:
                rows = torch.cat([torch.tensor([0, m - 1], device=dev),
                                  torch.randint(1, m - 1, (62,), device=dev, generator=gen)])
                err = scale = 0.0
                for c0 in range(0, n, K3_TWIN_COLS):
                    c1 = min(n, c0 + K3_TWIN_COLS)
                    ref = im.int4_matmul_grouped_hl8_ref(
                        x[rows], weights[0][0][:, c0:c1].contiguous(),
                        weights[0][1][:, c0:c1].contiguous())
                    err = max(err, (out[rows, c0:c1] - ref).abs().max().item())
                    scale = max(scale, ref.abs().max().item())
                    del ref
            else:
                ref = im.int4_matmul_grouped_hl8_ref(x, *weights[0])
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
            torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and err <= K3_REL_TOL * scale):
                fail(f"K3 M={m} K={k} N={n}: max|err| {err:.3e} > {K3_REL_TOL} * {scale:.3e}")
            del out
            args, lib_args, iters = _k3_calls(m, x, weights, w_bf16)
            plain = None if m == K3_PREFILL_M else time_ms(im.int4_matmul_grouped_hl8_ref,
                                                           args, 5, 1)
            ms = time_ms(im.int4_matmul_grouped_hl8, args, iters)
            lib = time_ms(torch.matmul, lib_args, iters)
            bound, bound_by = _k3_bound(m, k, n)
            cases[(m, k, n)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                    bound_by=bound_by, max_abs_err=err, ref_max=scale,
                                    per_step=per_step, regime=im._k3_regime(m, GROUP))
            log(f"K3 M={m:4d} K={k:6d} N={n:6d} (regime {im._k3_regime(m, GROUP)}): err "
                f"{err:.3e} (tol {K3_REL_TOL * scale:.3e}) kernel {ms:.4f} ms, plain "
                f"{'-' if plain is None else f'{plain:.4f}'} ms, torch.matmul bf16 {lib:.4f} ms, "
                f"bound {bound:.4f} ms ({bound_by}, {bound / ms:.1%} of it)")
            del x, args, lib_args
        del weights, w_bf16
        torch.cuda.empty_cache()
    report["k3_cases"] = [dict(m=m, k=k, n=n, **v) for (m, k, n), v in cases.items()]
    # the kernels line: one decode step at M = 8 (129 calls); the device times and the
    # prefill's figures join it in k3_device_times
    step = [v for (m, _, _), v in cases.items() if m == 8]
    return dict({key: sum(v[key] * v["per_step"] for v in step)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
                max_abs_err=max(v["max_abs_err"] for v in cases.values()),
                bound_by="bytes" if all(v["bound_by"] == "bytes" for v in step)
                else "operations")


def k3_device_times(dev, gen, report, row):
    """K3's device time (``torch.profiler``) at phase 3's shapes, M = 8 and
    6,000, beside ``torch.matmul``'s on the dequantized bf16 weight, on
    fresh weights from ``gen``; adds a decode step's and a prefill's 129
    calls to the kernels-line ``row``. Taken after the serving phases, so
    that no profiler session runs before them (as in the smoke runs before
    this reading was added)."""
    from micronet_tpu_torch.ops import int4_matmul as im

    cases = {(c["m"], c["k"], c["n"]): c for c in report["k3_cases"]}
    for (k, n), _ in K3_SHAPES:
        weights, w_bf16 = _k3_weights(k, n, dev, gen)
        for m in (8, K3_PREFILL_M):
            x = torch.randn((m, k), device=dev, generator=gen)
            args, lib_args, iters = _k3_calls(m, x, weights, w_bf16)
            per_call = 2 if im._k3_regime(m, GROUP) == "B" else 1  # B: the x pre-pass, the GEMM
            case = cases[m, k, n]
            case["device_ms"] = device_ms(im.int4_matmul_grouped_hl8, args, iters, per_call)
            case["library_device_ms"] = device_ms(torch.matmul, lib_args, iters)
            log(f"K3 M={m:4d} K={k:6d} N={n:6d}: device {case['device_ms']:.4f} ms, "
                f"torch.matmul bf16 {case['library_device_ms']:.4f} ms, bound "
                f"{case['bound_ms']:.4f} ms ({case['bound_ms'] / case['device_ms']:.1%} of it)")
            del x, args, lib_args
        del weights, w_bf16
        torch.cuda.empty_cache()

    def forward(m, keys):  # the 129 calls of one forward at M = m
        return {key: sum(v[key] * v["per_step"] for (mm, _, _), v in cases.items() if mm == m)
                for key in keys}

    row.update(forward(8, ("device_ms", "library_device_ms")))
    pre = forward(K3_PREFILL_M, ("ms", "bound_ms", "device_ms", "library_device_ms"))
    row.update({f"prefill_{key}": v for key, v in pre.items()},
               prefill_m=K3_PREFILL_M, prefill_bound_share=pre["bound_ms"] / pre["device_ms"])
    report["k3_cases"] = list(cases.values())
    log(f"K3 forward at M=8: device {row['device_ms']:.3f} ms, torch.matmul "
        f"{row['library_device_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms; at M="
        f"{K3_PREFILL_M}: device {pre['device_ms']:.2f} ms, torch.matmul "
        f"{pre['library_device_ms']:.2f} ms, bound {pre['bound_ms']:.2f} ms "
        f"({row['prefill_bound_share']:.1%} of it)")


def check_attention(dev, gen, report):
    from micronet_tpu_torch.ops import decode_attention as da

    g, r, d, s = ATT_G, ATT_R, ATT_D, ATT_S
    bound = torch.randint(1, s + 1, (g,), generator=gen, device=dev).to(torch.int32)
    bound[0], bound[1] = 1, s  # ragged, with the extremes
    ncopy = copies_for(2 * g * s * (d + 4))

    def cache():
        return (torch.randint(-127, 128, (g, s, d), dtype=torch.int8, device=dev, generator=gen),
                torch.rand((g, s), device=dev, generator=gen) * 0.02 + 1e-3,
                torch.randint(-127, 128, (g, s, d), dtype=torch.int8, device=dev, generator=gen),
                torch.rand((g, s), device=dev, generator=gen) * 0.02 + 1e-3)

    caches = [cache() for _ in range(ncopy)]
    q = torch.randn((g, r, d), device=dev, generator=gen)
    cur = (torch.randint(-127, 128, (g, d), dtype=torch.int8, device=dev, generator=gen),
           torch.rand((g,), device=dev, generator=gen) * 0.02 + 1e-3,
           torch.randint(-127, 128, (g, d), dtype=torch.int8, device=dev, generator=gen),
           torch.rand((g,), device=dev, generator=gen) * 0.02 + 1e-3)
    out = {}
    for name, fn, twin, extra in (
        ("decode_attend_q8kv_cur", da.decode_attend_q8kv_cur, da.decode_attend_q8kv_cur_ref, cur),
        ("decode_attend_q8kv", da.decode_attend_q8kv, da.decode_attend_q8kv_ref, ()),
    ):
        args = [(*c, q, bound, *extra) for c in caches]
        got = fn(*args[0])
        ref = twin(*args[0])
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not (torch.isfinite(got).all() and err <= ATT_ABS_TOL):
            fail(f"{name}: max|err| {err:.3e} > {ATT_ABS_TOL}")
        ms = time_ms(fn, args, 50)
        plain = time_ms(twin, args, 5, 1)
        lib, bnd = attention_yardsticks(q, *caches[0], bound, cur if extra else None)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, max_abs_err=err, **bnd)
        log(f"{name} G={g} R={r} D={d} S={s} (bounds 1..{s}, {bnd['visible_rows']} visible "
            f"rows): err {err:.3e} (tol {ATT_ABS_TOL}), kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa bf16 {lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms")
    # K4a again at the serving loop's own fills (phase 5's decode steps)
    fills = torch.randint(SERVE_FILLS[0], SERVE_FILLS[1] + 1, (g,), generator=gen,
                          device=dev).to(torch.int32)
    fills[0], fills[1] = SERVE_FILLS
    args = [(*c, q, fills, *cur) for c in caches]
    err = (da.decode_attend_q8kv_cur(*args[0]) - da.decode_attend_q8kv_cur_ref(*args[0])).abs()
    err = err.max().item()
    if err > ATT_ABS_TOL:
        fail(f"decode_attend_q8kv_cur at fills {SERVE_FILLS}: max|err| {err:.3e} > {ATT_ABS_TOL}")
    ms = time_ms(da.decode_attend_q8kv_cur, args, 50)
    plain = time_ms(da.decode_attend_q8kv_cur_ref, args, 5, 1)
    lib, bnd = attention_yardsticks(q, *caches[0], fills, cur)
    out["decode_attend_q8kv_cur"].update(
        fills_ms=ms, fills_plain_ms=plain, fills_library_ms=lib, fills_max_abs_err=err,
        fills_bound_ms=bnd["bound_ms"], fills_visible_rows=bnd["visible_rows"])
    log(f"decode_attend_q8kv_cur G={g} R={r} D={d} S={s} (bounds {SERVE_FILLS[0]}.."
        f"{SERVE_FILLS[1]}, {bnd['visible_rows']} visible rows): err {err:.3e}, kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa bf16 {lib:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms")
    report["attention_clusters_at_once"] = {
        f"S={ss}": da.cluster_occupancy(r, ss) for ss in (ATT_S, LONG_CTX)}
    log(f"decode attention: clusters of {da._plan(s)[0]} blocks; the card holds "
        f"{report['attention_clusters_at_once']} of them at once (R={r})")
    report["attention"] = out
    del caches
    torch.cuda.empty_cache()
    return out


def attention_cases(dev, gen):
    """The decode-attention calls timed by device time, on fresh inputs from
    ``gen``, built one case at a time: yields (key, wrapper, argument
    lists, S). K4a at phase 3's shape (bounds 1..2,048) and at the serving
    fills, K4b at phase 10's (S = 8,192, bounds 0..8,192), K6 over a
    shuffled pool of pages of 16 at phase 10's shape, and the dense kernel
    over K6's gathered view (``K4b_view``, the same bounds)."""
    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import paged_attention as pa

    g, r, d = ATT_G, ATT_R, ATT_D
    ri = lambda *shape: torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                                      generator=gen)
    rf = lambda *shape: torch.rand(shape, device=dev, generator=gen) * 0.02 + 1e-3
    q = torch.randn((g, r, d), device=dev, generator=gen)
    cur = (ri(g, d), rf(g), ri(g, d), rf(g))

    def bounds(lo, hi):
        b = torch.randint(lo, hi + 1, (g,), generator=gen, device=dev).to(torch.int32)
        b[0], b[1] = lo, hi
        return b

    for key, s, b, fn in (("K4a", ATT_S, bounds(1, ATT_S), da.decode_attend_q8kv_cur),
                          ("K4a_fills", ATT_S, bounds(*SERVE_FILLS), da.decode_attend_q8kv_cur),
                          ("K4b", LONG_CTX, bounds(0, LONG_CTX),
                           da.decode_attend_q8kv_blocked_cur)):
        caches = [(ri(g, s, d), rf(g, s), ri(g, s, d), rf(g, s))
                  for _ in range(copies_for(2 * g * s * (d + 4)))]
        yield key, fn, [(*c, q, b, *cur) for c in caches], s
        del caches
    slots, heads = SLOTS, g // SLOTS
    lengths = torch.randint(1, LONG_CTX + 1, (slots,), generator=gen, device=dev).to(torch.int32)
    lengths[:4] = torch.tensor([0, LONG_CTX, 1, PAGES_E2E + 1])
    pool, table = _shuffled_pool(dev, gen, lengths, PAGE, heads)
    qp = torch.randn((slots, heads, r, d), device=dev, generator=gen)
    curp = (ri(slots, heads, d), rf(slots, heads), ri(slots, heads, d), rf(slots, heads))
    yield "K6", pa.paged_decode_attend_cur, [(*pool, table, lengths, qp, *curp)], LONG_CTX
    view = (*pa._gather_dense_batch(pool[0], pool[1], table),
            *pa._gather_dense_batch(pool[2], pool[3], table))
    del pool
    yield "K4b_view", da.decode_attend_q8kv_blocked_cur, [
        (*view, qp.reshape(g, r, d), lengths[:, None].expand(slots, heads).reshape(g).contiguous(),
         *(t.reshape(g, *t.shape[2:]) for t in curp))], LONG_CTX


def attention_device_times(dev, gen, report, att, long_att):
    """K4a (phase 3's bounds and the serving fills), K4b and K6 (pages of
    16) at their phase 3 and 10 shapes by device time (``torch.profiler``),
    on the inputs of :func:`attention_cases`, into the kernels-line rows
    ``att`` and ``long_att``. Taken after the serving phases, as K3's are."""
    from micronet_tpu_torch.ops import decode_attention as da

    readings = {}
    for key, fn, calls, s in attention_cases(dev, gen):
        # kernels one call launches: 1 in the cluster regime, 3 split
        readings[key] = device_ms(fn, calls, 30, 1 if da._plan(s)[0] else 3)
        del calls
    torch.cuda.empty_cache()
    att["decode_attend_q8kv_cur"].update(device_ms=readings["K4a"],
                                         fills_device_ms=readings["K4a_fills"])
    long_att["decode_attend_q8kv_blocked_cur"]["device_ms"] = readings["K4b"]
    long_att[f"paged_decode_attend_cur_page{PAGE}"].update(
        device_ms=readings["K6"], dense_view_device_ms=readings["K4b_view"])
    report["attention_device_ms"] = readings
    log(f"decode attention by device time: K4a {readings['K4a']:.4f} ms (bounds 1..{ATT_S}), "
        f"{readings['K4a_fills']:.4f} ms (bounds {SERVE_FILLS[0]}..{SERVE_FILLS[1]}); K4b "
        f"{readings['K4b']:.4f} ms and K6 {readings['K6']:.4f} ms (S={LONG_CTX}, pages of "
        f"{PAGE}: {readings['K6'] / readings['K4b']:.3f}x K4b; {readings['K6'] / readings['K4b_view']:.3f}x "
        f"K4b over K6's gathered view, {readings['K4b_view']:.4f} ms, the same bounds)")


def attention_yardsticks(q, kc, ks, vc, vs, bound, cur=None, extra_bytes=0):
    """For one decode-attention call over a dense (G, S, D) cache (the
    current rows ``cur`` as one more column, or None): the library
    yardstick, SDPA over the dequantized bf16 cache with the bounds as a
    mask, in ms; and the least time the card could take, from the bytes
    the call must move (each visible row's codes and scales, q, the
    output, the bounds, plus ``extra_bytes``) and its operations."""
    g, s, d = kc.shape
    r = q.shape[1]
    kf = (kc.float() * ks[..., None]).to(torch.bfloat16)
    vf = (vc.float() * vs[..., None]).to(torch.bfloat16)
    pos = torch.arange(s + (cur is not None), device=kc.device)
    mask = pos[None, :] < bound[:, None]
    if cur is not None:
        kf = torch.cat([kf, (cur[0].float() * cur[1][:, None]).to(torch.bfloat16)[:, None]], 1)
        vf = torch.cat([vf, (cur[2].float() * cur[3][:, None]).to(torch.bfloat16)[:, None]], 1)
        mask = mask | (pos[None, :] == s)
    mask = mask[:, None, :].expand(g, r, mask.shape[-1])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(lambda a, b, c, m: sdpa(a, b, c, attn_mask=m),
                  [(q.to(torch.bfloat16), kf, vf, mask)], 50)
    del kf, vf
    vis = int(bound.to(torch.int64).clamp(max=s).sum()) + (g if cur is not None else 0)
    nbytes = vis * (2 * d + 8) + g * r * d * 4 * 2 + g * 4 + extra_bytes
    ops = 4 * r * d * vis
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return lib, dict(bound_ms=max(t_bytes, t_ops) * 1e3, visible_rows=vis,
                     bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 4


def check_reference(dev):
    """A small Llama (head_dim 128, GQA 2, W4 g128) on the card against the
    same weights on the CPU, where every wrapper runs its plain twin:
    prefill logits (T = 40, 17 and the T = 1 path) and one batched decode
    step at those ragged fills, on the same tokens."""
    from micronet_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(vocab=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      mlp_dim=1024, max_seq=256)
    cpu = Llama(cfg, w4_group=GROUP, device="cpu",
                generator=torch.Generator().manual_seed(7))
    gpu = Llama(cfg, w4_group=GROUP, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab, n).tolist()
               for i, n in enumerate((40, 1, 17))]
    results = []
    for model in (cpu, gpu):
        d = model.device
        caches = model.init_cache_batch(len(prompts))
        logits = []
        for slot, p in enumerate(prompts):
            lg, single = model.forward(torch.tensor(p, device=d), model.init_cache(), 0)
            logits.append(lg)
            for full, one in zip(caches, single):
                for f in ("k_codes", "k_scale", "v_codes", "v_scale", "length"):
                    getattr(full, f)[slot] = getattr(one, f)
        lg, _ = model.decode_batch(
            torch.tensor([[5], [6], [7]], device=d), caches,
            torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=d))
        logits.append(lg[:, 0])
        results.append(torch.cat(logits).cpu())
    ref, got = results
    worst = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (torch.isfinite(got).all() and worst <= MODEL_REL_TOL * scale):
        fail(f"reference: card vs CPU logits differ by {worst:.3e} (max {scale:.3e})")
    log(f"reference: small Llama, card vs CPU twins: max|diff| {worst:.3e} "
        f"(tol {MODEL_REL_TOL} x {scale:.3e})")
    return worst


# ---------------------------------------------------------------- phase 5


class _Timed:
    """Model proxy timing every prefill and decode step (synchronised)."""

    def __init__(self, model):
        self._m = model
        self.decode_s, self.prefill_s, self.prefill_tokens = [], [], []

    def __getattr__(self, name):
        return getattr(self._m, name)

    def _time(self, fn, sink, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    def forward(self, *a):  # the loop's prefills: a[0] is the prompt
        self.prefill_tokens.append(int(a[0].shape[0]))
        return self._time(self._m.forward, self.prefill_s, *a)

    def decode_batch(self, *a):
        return self._time(self._m.decode_batch, self.decode_s, *a)

    def decode_batch_paged(self, *a):
        return self._time(self._m.decode_batch_paged, self.decode_s, *a)


def profile_decode(model, dev, reqs, report, out_dir: Path, key="profile", **loop_kw):
    """A traced run of 5 decode steps with all 8 slots busy (``loop_kw``
    for ``ServeLoop``, e.g. the paged loop's)."""
    from micronet_tpu_torch.serve import Request, ServeLoop

    loop = ServeLoop(model, SLOTS, device=dev, **loop_kw)
    for r in reqs[:SLOTS]:
        loop.submit(Request(1000 + r.rid, r.prompt, NEW_TOKENS))
    loop.step()  # admits every slot
    loop.step()
    report[key] = trace(loop.step, 5, f"{key}: decode steps at {SLOTS} busy slots",
                        out_dir / f"chip_smoke_{key}.txt")


def trace(step, steps: int, what: str, table: Path) -> dict:
    """``steps`` calls of ``step`` under ``torch.profiler``: the device's
    busy share of the wall time and the kernel time by name (the full
    table goes to ``table``). Tracing adds host time, so untraced times
    are the end-to-end figures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: an operator's row repeats the time of the kernels it launched
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    table.write_text(events.table(sort_by="self_device_time_total", row_limit=40))
    launches = sum(e.count for e in kernels) // steps
    log(f"profile: {steps} {what}, traced wall {1e3 * wall / steps:.2f} ms each, device busy "
        f"{1e3 * device_s / steps:.2f} ms each ({100 * device_s / wall:.1f}% busy), "
        f"{launches} kernel launches each")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:9.3f} ms  {e.count // steps:6d} "
            f"calls  {e.key[:90]}")
    return dict(steps=steps, wall_s=wall, device_busy_s=device_s, busy_share=device_s / wall,
                launches_per_step=launches, by_kernel=[dict(name=e.key, calls=e.count,
                                device_ms=e.self_device_time_total / 1e3) for e in top])


def serve(dev, seed, report, profile_dir=None):
    from micronet_tpu_torch.models.llama import Llama, llama3_8b
    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import int4_matmul as im
    from micronet_tpu_torch.serve import Request, ServeLoop

    cfg = llama3_8b(2048)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama(cfg, w4_group=GROUP, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in list(model.parameters()) + list(model.buffers())) / 1e9
    log(f"serve: built Llama-3-8B W4 g{GROUP} in {build_s:.1f} s, "
        f"{weights_gb:.2f} GB of weights, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 257, N_REQUESTS)
    lens[0], lens[1] = 16, 256
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, n)], NEW_TOKENS)
            for i, n in enumerate(lens)]
    timed = _Timed(model)
    loop = ServeLoop(timed, SLOTS, device=dev)
    for r in reqs:
        loop.submit(r)

    kernels = (im.int4_matmul_grouped_hl8, da.decode_attend_q8kv_cur, da.decode_attend_q8kv)
    for k in kernels:
        k.launches = 0
    # -- the main path: the serving loop, then one request alone --------
    active_per_step = []
    t0 = time.perf_counter()
    while loop.queue or any(r is not None for r in loop.slot_req):
        loop.step()
        active_per_step.append(sum(r is not None for r in loop.slot_req))
    serve_s = time.perf_counter() - t0
    served = {k.__name__: k.launches for k in kernels}
    iso = model.generate(torch.tensor(reqs[0].prompt, device=dev), NEW_TOKENS).tolist()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    # ------------------------------------------------------------------
    done = loop.finished
    if sorted(done) != list(range(N_REQUESTS)):
        fail(f"served {sorted(done)} of {N_REQUESTS} requests")
    for r in done.values():
        if len(r.output) != NEW_TOKENS or not all(0 <= t < cfg.vocab for t in r.output):
            fail(f"request {r.rid}: bad output {r.output}")
    if done[0].output != iso:
        fail(f"request 0 served {done[0].output} but alone {iso}")
    steps, prefills = len(timed.decode_s), len(timed.prefill_s)
    per_fwd = 4 * cfg.n_layers + 1
    want = {
        "int4_matmul_grouped_hl8": per_fwd * (steps + prefills + NEW_TOKENS),
        "decode_attend_q8kv_cur": cfg.n_layers * steps,
        "decode_attend_q8kv": cfg.n_layers * (NEW_TOKENS - 1),
    }
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    # every token after a request's first comes from a decode step
    tokens = N_REQUESTS * (NEW_TOKENS - 1)
    decode_s = sum(timed.decode_s)
    step_ms = sorted(1e3 * x for x in timed.decode_s)
    res = dict(
        build_s=build_s, weights_gb=weights_gb, serve_s=serve_s, decode_steps=steps,
        prefills=prefills, prefill_s=sum(timed.prefill_s), decode_s=decode_s,
        decode_tokens=tokens, decode_tok_per_s=tokens / decode_s,
        step_ms_median=step_ms[len(step_ms) // 2], step_ms_max=step_ms[-1],
        launches=launches, launches_serving=served,
        k3_per_decode_step=per_fwd, k4a_per_decode_step=cfg.n_layers,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        active_per_step=active_per_step, prompt_lens=[int(n) for n in lens],
    )
    report["serve"] = res
    log(f"serve: {N_REQUESTS} requests, {steps} decode steps, {prefills} prefills in "
        f"{serve_s:.2f} s; decode {tokens} tokens in {decode_s:.3f} s = "
        f"{tokens / decode_s:.1f} tok/s; step median {res['step_ms_median']:.2f} ms, "
        f"max {res['step_ms_max']:.2f} ms; prefill total {sum(timed.prefill_s):.2f} s; "
        f"peak {res['peak_gb']:.2f} GB")
    log(f"serve: launches {launches} (serving loop alone: {served}); "
        f"request 0 matches its isolated generate run")
    if profile_dir is not None:
        profile_decode(model, dev, reqs, report, profile_dir)
    return launches


# ---------------------------------------------------------------- phase 3b


def k1_args(m, k, n, s_x, zp, qmin, qmax, dev, gen):
    """K1's arguments at one call of ``K1_CASES``: x with a quarter of its
    values on .5 code boundaries, int8 weights, column scales, s_x and zp
    as f32 tensors on the card."""
    x = torch.randn((m, k), device=dev, generator=gen) * (40 * s_x)
    ties = (torch.randint(-20, 20, (m, k), device=dev, generator=gen) + 0.5) * s_x
    x = torch.where(torch.rand((m, k), device=dev, generator=gen) < 0.25, ties, x)
    w_q = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
    ws = torch.rand((n,), device=dev, generator=gen) * 0.02 + 1e-3
    return (x, w_q, ws, torch.tensor(s_x, device=dev), torch.tensor(zp, device=dev), qmin, qmax)


def k2_args(label, m, k, n, dev, gen):
    """K2's arguments at one call of ``K2_CASES``; "zeros" holds exact zeros,
    -0.0 and NaN in x."""
    x = torch.randn((m, k), device=dev, generator=gen)
    if label == "zeros":
        x = torch.where(torch.rand((m, k), device=dev, generator=gen) < 0.25, 0.0, x)
        x = torch.where(torch.rand((m, k), device=dev, generator=gen) < 0.25, -0.0, x)
        x[0, :4] = float("nan")
    w_q = torch.randint(-1, 2, (k, n), dtype=torch.int8, device=dev, generator=gen)
    alpha = torch.rand((n,), device=dev, generator=gen) + 0.5
    return (x, w_q, alpha)


def int_mm_args(codes, w_q):
    """``torch._int_mm``'s arguments for codes (M, K) times w_q (K, N): the
    weight as a column-major (K, N') view, N padded to what ``_int_mm``
    takes."""
    k, n = w_q.shape
    w_nk = torch.zeros((max(16, -(-n // 8) * 8), k), dtype=torch.int8, device=w_q.device)
    w_nk[:n] = w_q.t()
    return (codes, w_nk.t())


def int8_regimes(i8, binary):
    """K1's (or, ``binary``, K2's) two regimes forced, taking the public
    wrapper's arguments; they count no launch."""
    if binary:
        return {"small": lambda x, w, a: i8._small_call(x, w, a),
                "gemm": lambda x, w, a: i8._gemm_call(x, w, a)}
    return {"small": lambda x, w, ws, s, z, lo, hi: i8._small_call(x, w, ws, (s, z, lo, hi)),
            "gemm": lambda x, w, ws, s, z, lo, hi: i8._gemm_call(x, w, ws, (s, z, lo, hi))}


def check_int8_call(what, fn, ref_fn, binary, args, regime):
    """One K1 or K2 call: the public wrapper and both regimes forced, each
    against the twin bit for bit (fatal otherwise); returns max|err|."""
    from micronet_tpu_torch.ops import int_matmul as i8

    ref = ref_fn(*args)
    err = 0.0
    for name, call in [(f"wrapper (regime {regime})", fn)] + list(int8_regimes(i8, binary).items()):
        got = call(*args)
        torch.cuda.synchronize()
        err = max(err, (got - ref).abs().max().item())
        if not torch.equal(got, ref):
            fail(f"{what} {name}: differs from its twin (max|err| {err:.3e}, "
                 f"{int((got != ref).sum())} elements)")
    return err


def int8_bound(m, k, n, extra_bytes=0):
    """K1's/K2's least time (ms): x (f32) and w_q read, the column scales
    read, out (f32) written; 2MKN int8 operations."""
    nbytes = m * k * 4 + k * n + n * 4 + m * n * 4 + extra_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_k1(dev, gen, report):
    """K1 against its twin, bit for bit, at the engine's call, a large call
    and a ragged A4 call with zp != 0: the public wrapper in the regime
    ``_k1_regime`` picks, and each regime forced. The library yardstick is
    ``torch._int_mm`` over codes quantized beforehand: the integer product
    only, without the quantize and the dequantize that K1 fuses (N padded
    to 16, which ``_int_mm`` needs). Device times come at the end of phase
    12 (:func:`int8_device_times`)."""
    from micronet_tpu_torch.ops import _build
    from micronet_tpu_torch.ops import int_matmul as i8

    out_cases = {}
    for label, m, k, n, s_x, zp, qmin, qmax, iters in K1_CASES:
        args = k1_args(m, k, n, s_x, zp, qmin, qmax, dev, gen)
        regime = i8._k1_regime(m, k, n, _build.sm_count(dev))
        err = check_int8_call(f"K1 {label} M={m} K={k} N={n}", i8.int8_matmul_dequant,
                              i8.int8_matmul_dequant_ref, False, args, regime)
        ms = time_ms(i8.int8_matmul_dequant, [args], iters)
        plain = time_ms(i8.int8_matmul_dequant_ref, [args], max(3, iters // 20), 1)
        codes = i8.quantize_int8(args[0], s_x, zp, qmin, qmax)
        lib = time_ms(torch._int_mm, [int_mm_args(codes, args[1])], iters)
        bound, bound_by = int8_bound(m, k, n, extra_bytes=8)
        out_cases[label] = dict(m=m, k=k, n=n, zp=zp, qmin=qmin, qmax=qmax, ms=ms,
                                plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=bound_by,
                                max_abs_err=err, regime=regime)
        log(f"K1 {label:12s} M={m:5d} K={k:5d} N={n:5d} (regime {regime}): wrapper, small and "
            f"gemm regimes equal to the twin; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch._int_mm on codes {lib:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        del args, codes
    torch.cuda.empty_cache()
    report["k1_cases"] = out_cases
    return out_cases


def int8_device_times(dev, gen, report, k1_row, k2_row):
    """K1's device time (``torch.profiler``) at phase 7's three calls and
    K2's at its path call, on fresh inputs from ``gen``: the public wrapper
    (``per_call`` its kernels, ``_plan``'s count: 1 in the small regime, 2
    or 3 in the GEMM's), each regime forced, and ``torch._int_mm`` on
    codes made beforehand. Taken after the serving phases, as K3's are; adds
    ``device_ms``, ``library_device_ms`` and ``regime`` to the kernels-line
    rows."""
    from micronet_tpu_torch.ops import _build
    from micronet_tpu_torch.ops import int_matmul as i8

    def read(what, case, fn, binary, args, lib_args, iters):
        iters = min(iters, 50)
        per_call = {r: i8._plan(case["m"], case["k"], case["n"], r, _build.sm_count(dev))
                    ["launches"] for r in ("small", "gemm")}
        case["device_ms"] = device_ms(fn, [args], iters, per_call[case["regime"]])
        for regime, call in int8_regimes(i8, binary).items():
            call.__name__ = f"{fn.__name__}_{regime}"
            case[f"{regime}_device_ms"] = device_ms(call, [args], iters, per_call[regime])
        case["library_device_ms"] = device_ms(torch._int_mm, [lib_args], iters)
        log(f"{what}: device {case['device_ms']:.4f} ms (regime {case['regime']}; small "
            f"{case['small_device_ms']:.4f}, gemm {case['gemm_device_ms']:.4f}), torch._int_mm "
            f"{case['library_device_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
            f"({case['bound_ms'] / case['device_ms']:.1%} of it)")

    for label, m, k, n, s_x, zp, qmin, qmax, iters in K1_CASES:
        args = k1_args(m, k, n, s_x, zp, qmin, qmax, dev, gen)
        codes = i8.quantize_int8(args[0], s_x, zp, qmin, qmax)
        read(f"K1 {label:12s} M={m:5d} K={k:5d} N={n:5d}", report["k1_cases"][label],
             i8.int8_matmul_dequant, False, args, int_mm_args(codes, args[1]), iters)
        del args, codes
    label, m, k, n, iters = K2_CASES[0]
    args = k2_args(label, m, k, n, dev, gen)
    codes = torch.where(args[0] >= 0, 1, -1).to(torch.int8)
    read(f"K2 {label:12s} M={m:5d} K={k:5d} N={n:5d}", report["k2_cases"][label],
         i8.binary_act_matmul, True, args, int_mm_args(codes, args[1]), iters)
    del args, codes
    torch.cuda.empty_cache()
    for row, case in ((k1_row, report["k1_cases"]["path"]), (k2_row, report["k2_cases"]["path"])):
        row.update({key: case[key] for key in ("device_ms", "library_device_ms", "regime")})


# ---------------------------------------------------------------- phase 3c


def _route_layer(dev, gen, cin, size, cout, k, stride, pad, groups, w4):
    from micronet_tpu_torch.infer.engine import IntConv2d, _maybe_pack_w4

    lim = 8 if w4 else 128
    w = torch.randint(1 - lim, lim, (cout, cin // groups, k, k), dtype=torch.int8,
                      device=dev, generator=gen)
    conv = IntConv2d(w, torch.rand(cout, device=dev, generator=gen) * 0.01 + 1e-3,
                     torch.tensor(0.03), None, (stride, stride), (pad, pad), (1, 1), groups,
                     -float(lim), lim - 1.0)
    if w4:
        _maybe_pack_w4(conv, conv._weights_hwio().reshape(-1, cout))
    x = torch.randint(-lim, lim, (ROUTE_BATCH, cin, size, size), dtype=torch.int8, device=dev,
                      generator=gen)
    return conv, w, x


def check_conv_routes(dev, gen, report):
    """Every IntConv2d route at ResNet-18's and NIN-GC's layer shapes.
    Integer layers: the int32 accumulator of im2col + ``torch._int_mm``
    against an f64 convolution of the same codes, bit for bit. The first
    layer: its f32 convolution of dequantized values (TF32 on outside, off
    inside the call) against the same convolution in f64."""
    import torch.nn.functional as TF

    rows = []
    for model, shapes, w4 in (("resnet18", RESNET_CONVS, False), ("nin_gc", NIN_CONVS, True)):
        for cin, size, cout, k, stride, pad, groups in shapes:
            conv, w, x = _route_layer(dev, gen, cin, size, cout, k, stride, pad, groups, w4)
            shape = f"{model} {cin}->{cout} k{k} s{stride} g{groups} at {size}x{size}"
            if conv.f32_dequant:
                torch.backends.cudnn.allow_tf32 = True
                try:
                    got = conv.dequant_conv(x)
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                xd = x.double() * conv.act_scale.double()
                wd = w.double() * conv.w_scale.double()[:, None, None, None]
                ref = TF.conv2d(xd, wd, None, stride, pad, 1, groups)
                err = (got.double() - ref).abs().max().item()
                tol = F32_ROUTE_RTOL * ref.abs().max().item()
                ok = err <= tol
                rows.append(dict(layer=shape, route="f32 dequant", max_abs_err=err, tol=tol))
            else:
                got = conv.int_acc(x)
                ref = TF.conv2d(x.double(), w.double(), None, stride, pad, 1, groups)
                if not torch.equal(ref, ref.round()):  # an inexact f64 algorithm: use the CPU
                    ref = TF.conv2d(x.cpu().double(), w.cpu().double(), None, stride, pad, 1,
                                    groups).to(dev)
                ok = got.dtype == torch.int32 and torch.equal(got.double(), ref)
                err = (got.double() - ref).abs().max().item()
                rows.append(dict(layer=shape, route="im2col + _int_mm", max_abs_err=err))
            torch.cuda.synchronize()
            if not ok:
                fail(f"conv route {rows[-1]['route']} at {shape}: max|err| {err:.3e}")
    log(f"conv routes: {len(rows)} layer shapes at batch {ROUTE_BATCH}: every im2col + "
        f"_int_mm accumulator equals the f64 conv; the f32 first layers within "
        f"{F32_ROUTE_RTOL:g} x max|ref| (worst "
        f"{max(r['max_abs_err'] for r in rows if 'tol' in r):.3e})")
    report["conv_routes"] = rows


# ---------------------------------------------------------------- phases 6, 7


def _forward_ms(model, x, iters):
    """Mean ms of ``model(x)`` over ``iters`` forwards (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.no_grad()
def engine_path(name, build, cfg, batch, dev, seed, report, profile_dir=None):
    """One IAO engine flow at full width on the card: random weights from a
    seeded generator, ``prepare``, calibration forwards in train mode,
    ``fuse_bn_iao``, ``freeze_int`` with an example input, then the engine
    at ``batch``. The kernel counts are zeroed just before the engine
    forwards and read just after. The same engine on the CPU (the
    wrappers' twins, f64 convs) must agree on a few images."""
    import copy

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode

    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = build(device=dev, generator=gen)
    fp32 = eval_mode(copy.deepcopy(model))
    q = train_mode(prepare(model, cfg, device=dev))
    for _ in range(CALIB_STEPS):
        q(torch.randn((CALIB_BATCH, 32, 32, 3), device=dev, generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=dev))
    x = torch.randn((batch, 32, 32, 3), device=dev, generator=gen)
    engine = eval_mode(freeze_int(fused, example_input=x[:1], device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    chained = [n for n, m in engine.named_modules() if getattr(m, "chained", False)]

    kernels = _all_kernels()
    for kern in kernels:
        kern.launches = 0
    # -- the main path: engine forwards --------------------------------
    out = engine(x)
    engine_ms = _forward_ms(engine, x, ENGINE_ITERS)
    launches = {kern.__name__: kern.launches for kern in kernels}
    # ------------------------------------------------------------------
    forwards = 1 + ENGINE_ITERS
    if tuple(out.shape) != (batch, 10) or not torch.isfinite(out).all():
        fail(f"{name}: engine output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    fp32(x)
    fp32_ms = _forward_ms(fp32, x, ENGINE_ITERS)
    if profile_dir is not None:
        report[f"{name}_profile"] = trace(lambda: engine(x), 3, f"{name} engine forwards",
                                          profile_dir / f"chip_smoke_{name}_profile.txt")
    fq = fused(x)
    fq_agree = (out.argmax(-1) == fq.argmax(-1)).float().mean().item()
    fq_diff = _agree(f"{name}: engine vs its fake-quant model", out[:CPU_BATCH],
                     fq[:CPU_BATCH], FQ_TOL)
    cpu_engine = copy.deepcopy(engine).to("cpu")
    t1 = time.perf_counter()
    ref = cpu_engine(x[:CPU_BATCH].cpu())
    cpu_s = time.perf_counter() - t1
    diff = _agree(f"{name}: engine on the card vs on the CPU", out[:CPU_BATCH].cpu(), ref,
                  CARD_CPU_TOL)
    res = dict(batch=batch, setup_s=setup_s, chained_layers=len(chained), launches=launches,
               forwards=forwards, engine_ms=engine_ms, engine_img_s=batch / engine_ms * 1e3,
               fp32_ms=fp32_ms, fp32_img_s=batch / fp32_ms * 1e3,
               engine_vs_fake_quant_max_abs=fq_diff, engine_vs_fake_quant_argmax_agree=fq_agree,
               card_vs_cpu_max_abs=diff, cpu_rows=CPU_BATCH, cpu_engine_s=cpu_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    report[name] = res
    log(f"{name}: setup {setup_s:.1f} s, {len(chained)} chained layers; engine at batch "
        f"{batch}: {engine_ms:.2f} ms = {res['engine_img_s']:.0f} img/s, port fp32 eval "
        f"(TF32 off) {fp32_ms:.2f} ms = {res['fp32_img_s']:.0f} img/s; launches {launches} "
        f"over {forwards} forwards")
    log(f"{name}: on {CPU_BATCH} images, engine vs its fake-quant model max|diff| "
        f"{fq_diff:.3e}, engine on the card vs on the CPU max|diff| {diff:.3e}; argmax "
        f"agreement with the fake-quant model over the batch {fq_agree:.4f}")
    return launches, forwards


def _agree(what, got, ref, rtol):
    """Fail unless ``got`` is within ``rtol * max(1, max|ref|)`` of ``ref``
    and has its argmax in every row whose top-2 margin in ``ref`` exceeds
    twice that tolerance (closer logits may swap within it). Returns the
    max |difference|."""
    diff = (got - ref).abs().max().item()
    tol = rtol * max(1.0, ref.abs().max().item())
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = got.argmax(-1) == ref.argmax(-1)
    if diff > tol or not bool(same[decided].all()):
        fail(f"{what}: max|diff| {diff:.3e} (tol {tol:.3e}), argmax equal {same.tolist()} "
             f"(rows decided by the tolerance {decided.tolist()})")
    return diff


def _all_kernels():
    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import int4_matmul as im
    from micronet_tpu_torch.ops import int_matmul as i8
    from micronet_tpu_torch.ops import paged_attention as pa

    return (im.int4_matmul_grouped_hl8, da.decode_attend_q8kv_cur, da.decode_attend_q8kv,
            i8.int8_matmul_dequant, da.decode_attend_q8kv_blocked_cur,
            da.decode_attend_q8kv_blocked, pa.paged_decode_attend_cur, pa.paged_decode_attend,
            i8.binary_act_matmul, im.int4_matmul, im.int4_matmul_grouped)


def resnet_engine(dev, seed, report, profile_dir=None):
    from micronet_tpu_torch.models.resnet import resnet18
    from micronet_tpu_torch.quant.config import QuantConfig

    launches, forwards = engine_path("resnet18_w8a8", resnet18,
                                     QuantConfig(a_bits=8, w_bits=8, bn_fuse=True),
                                     RESNET_BATCH, dev, seed, report, profile_dir)
    want = {k.__name__: 0 for k in _all_kernels()}
    want["int8_matmul_dequant"] = forwards  # the fc, once per forward
    if launches != want:
        fail(f"resnet18_w8a8: launch counts {launches}, expected {want}")
    return launches


def nin_engine(dev, seed, report, profile_dir=None):
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.quant.config import QuantConfig

    # NIN-GC's classifier is a 1x1 conv: this path runs no hand-written kernel
    engine_path("nin_gc_w4a4", Net, QuantConfig(a_bits=4, w_bits=4, bn_fuse=True),
                NIN_BATCH, dev, seed, report, profile_dir)


# ---------------------------------------------------------------- phase 10


def _shuffled_pool(dev, gen, lengths, page, heads):
    """A pool holding every slot's rows up to ``lengths`` in shuffled pages
    (table entries past a length point at the zero page, as the allocator
    leaves them), codes and scales random."""
    slots = lengths.shape[0]
    mp = LONG_CTX // page
    p = 1 + slots * mp
    pool = (torch.randint(-127, 128, (p, heads, page, ATT_D), dtype=torch.int8, device=dev,
                          generator=gen),
            torch.rand((p, heads, 1, page), device=dev, generator=gen) * 0.02 + 1e-3,
            torch.randint(-127, 128, (p, heads, page, ATT_D), dtype=torch.int8, device=dev,
                          generator=gen),
            torch.rand((p, heads, 1, page), device=dev, generator=gen) * 0.02 + 1e-3)
    for t in pool:
        t[0] = 0  # the zero page
    order = torch.randperm(p - 1, device=dev, generator=gen).to(torch.int32) + 1
    used = torch.arange(mp, device=dev)[None, :] * page < lengths[:, None]
    table = torch.where(used, order.reshape(slots, mp), 0).to(torch.int32).contiguous()
    return pool, table


def _check_close(name, got, ref):
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= LONG_ATT_TOL):
        fail(f"{name}: max|err| {err:.3e} > {LONG_ATT_TOL}")
    return err


def check_long_attention(dev, gen, report):
    """K4b/K5b at S = 8192 over a dense cache, K6/K7 over shuffled pools of
    pages of 16 and 512: each against its twin, K4b(b) = K5b(b + 1) and each
    paged kernel = the dense kernel over the gathered view, bit for bit."""
    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import paged_attention as pa

    g, r, d, s = ATT_G, ATT_R, ATT_D, LONG_CTX
    slots, heads = SLOTS, ATT_G // SLOTS
    ri = lambda *shape: torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                                      generator=gen)
    rf = lambda *shape: torch.rand(shape, device=dev, generator=gen) * 0.02 + 1e-3
    bound = torch.randint(1, s + 1, (g,), generator=gen, device=dev).to(torch.int32)
    bound[:5] = torch.tensor([0, s, 1, 512, 513])  # extremes and split edges
    cache = (ri(g, s, d), rf(g, s), ri(g, s, d), rf(g, s))
    q = torch.randn((g, r, d), device=dev, generator=gen)
    cur = (ri(g, d), rf(g), ri(g, d), rf(g))
    out = {}
    for name, fn, twin, extra in (
        ("decode_attend_q8kv_blocked_cur", da.decode_attend_q8kv_blocked_cur,
         da.decode_attend_q8kv_blocked_cur_ref, cur),
        ("decode_attend_q8kv_blocked", da.decode_attend_q8kv_blocked,
         da.decode_attend_q8kv_blocked_ref, ()),
    ):
        args = (*cache, q, bound, *extra)
        err = _check_close(name, fn(*args), twin(*args))
        ms = time_ms(fn, [args], 50)
        plain = time_ms(twin, [args], 5, 1)
        lib, bnd = attention_yardsticks(q, *cache, bound, cur if extra else None)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, max_abs_err=err, **bnd)
        log(f"{name} G={g} R={r} D={d} S={s} (bounds 0..{s}, {bnd['visible_rows']} visible "
            f"rows): err {err:.3e} (tol {LONG_ATT_TOL}), kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa bf16 {lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    # K4b at bound b == K5b at b + 1 over the cache with row b = the current row
    b = bound.clamp(max=s - 1)
    rows = torch.arange(g, device=dev)
    appended = [t.clone() for t in cache]
    for t, c in zip(appended, cur):
        t[rows, b.long()] = c
    if not torch.equal(da.decode_attend_q8kv_blocked_cur(*cache, q, b, *cur),
                       da.decode_attend_q8kv_blocked(*appended, q, b + 1)):
        fail("K4b at bound b differs from K5b at b + 1 over the appended cache")
    del appended, cache
    log(f"K4b at bound b equals K5b at b + 1 over the appended cache, bit for bit ({g} groups)")

    lengths = torch.randint(1, s + 1, (slots,), generator=gen, device=dev).to(torch.int32)
    lengths[:4] = torch.tensor([0, s, 1, PAGES_E2E + 1])
    qp = torch.randn((slots, heads, r, d), device=dev, generator=gen)
    curp = (ri(slots, heads, d), rf(slots, heads), ri(slots, heads, d), rf(slots, heads))
    dense_bound = lengths[:, None].expand(slots, heads).reshape(g).contiguous()
    curd = [t.reshape(g, *t.shape[2:]) for t in curp]
    for page in (PAGE, PAGES_E2E):
        pool, table = _shuffled_pool(dev, gen, lengths, page, heads)
        view = (*pa._gather_dense_batch(pool[0], pool[1], table),
                *pa._gather_dense_batch(pool[2], pool[3], table))
        pages_read = int((-(-lengths.to(torch.int64) // page)).sum())
        for name, fn, twin, extra, dense in (
            ("paged_decode_attend_cur", pa.paged_decode_attend_cur, pa.paged_decode_attend_cur_ref,
             curp, lambda: da.decode_attend_q8kv_cur(*view, qp.reshape(g, r, d), dense_bound,
                                                     *curd)),
            ("paged_decode_attend", pa.paged_decode_attend, pa.paged_decode_attend_ref, (),
             lambda: da.decode_attend_q8kv(*view, qp.reshape(g, r, d), dense_bound)),
        ):
            args = (*pool, table, lengths, qp, *extra)
            got = fn(*args)
            err = _check_close(f"{name} page {page}", got, twin(*args))
            if not torch.equal(got.reshape(g, r, d), dense()):
                fail(f"{name} page {page} differs from the dense kernel over the gathered view")
            ms = time_ms(fn, [args], 50)
            dense_ms = time_ms(dense, [()], 50)  # the same bounds, dense, over the view
            plain = time_ms(twin, [args], 5, 1)
            # the library call runs on the gathered view: the gather is not timed
            lib, bnd = attention_yardsticks(qp.reshape(g, r, d), *view, dense_bound,
                                            curd if extra else None,
                                            extra_bytes=4 * pages_read)
            out[f"{name}_page{page}"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                             max_abs_err=err, page=page, dense_view_ms=dense_ms,
                                             **bnd)
            log(f"{name} page {page} slots={slots} H={heads} R={r} S={s} (lengths 0..{s}): "
                f"err {err:.3e} (tol {LONG_ATT_TOL}), equal to the dense kernel over the "
                f"gathered view; kernel {ms:.4f} ms (dense over the view {dense_ms:.4f} ms), plain "
                f"{plain:.4f} ms, sdpa bf16 on the view {lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms")
        del pool, view
    report["long_attention"] = out
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 11


def _serve_all(loop, reqs):
    """Run ``reqs`` (fresh copies) through ``loop``; returns the outputs by
    request id, the admissions deferred and the wall seconds."""
    from micronet_tpu_torch.serve import Request

    for r in reqs:
        loop.submit(Request(r.rid, list(r.prompt), r.max_new_tokens))
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(done) != [r.rid for r in reqs]:
        fail(f"served {sorted(done)} of {len(reqs)} requests")
    for r in done.values():
        if len(r.output) != r.max_new_tokens:
            fail(f"request {r.rid}: {len(r.output)} of {r.max_new_tokens} tokens "
                 f"(truncated: the pool ran out)")
    return {rid: r.output for rid, r in done.items()}, loop.deferred, wall


def _loop_stats(timed, wall, peak, kv_bytes, deferred):
    tokens = N_REQUESTS * (NEW_TOKENS - 1)  # every token after a request's first
    decode_s = sum(timed.decode_s)
    step_ms = sorted(1e3 * x for x in timed.decode_s)
    long_s = [t for n, t in zip(timed.prefill_tokens, timed.prefill_s) if n == LONG_PROMPTS[0]]
    return dict(wall_s=wall, decode_steps=len(step_ms), prefills=len(timed.prefill_s),
                prefill_s=sum(timed.prefill_s), prefill_max_s=max(timed.prefill_s),
                prefill_long_s=long_s[0] if long_s else None,
                decode_s=decode_s, decode_tok_per_s=tokens / decode_s,
                step_ms_median=step_ms[len(step_ms) // 2], step_ms_max=step_ms[-1],
                kv_bytes=kv_bytes, peak_gb=peak / 1e9, deferred_admissions=deferred)


def serve_long(dev, seed, card, report, profile_dir=None):
    """Slice 3's main path: W4 Llama-3-8B at its 8,192-token context through
    the dense and the paged ServeLoop, then one long request alone."""
    from micronet_tpu_torch.models.llama import Llama, llama3_8b
    from micronet_tpu_torch.quant.kv_cache import kv_cache_bytes
    from micronet_tpu_torch.quant.paged_kv import paged_hbm_bytes
    from micronet_tpu_torch.serve import Request, ServeLoop

    cfg = llama3_8b(LONG_CTX)
    model = Llama(cfg, w4_group=GROUP, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed + 1))
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(SHORT_PROMPTS[0], SHORT_PROMPTS[1] + 1, N_REQUESTS)
    lens[0], lens[SLOTS - 1] = LONG_PROMPTS
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, n)], NEW_TOKENS)
            for i, n in enumerate(lens)]
    # every request reserves its prompt and the rows its decode appends;
    # the pool holds what the first seven reserve: they are admitted with
    # their growth covered, and the eighth (4,500 tokens) waits until they
    # finish, since its pages exceed the growth they leave free
    reserve = [-(-(int(n) + NEW_TOKENS - 1) // PAGE) for n in lens]
    usable = sum(reserve[: SLOTS - 1])
    if not usable < sum(reserve[:SLOTS]) or usable < max(reserve):
        fail(f"pool of {usable} pages cannot defer the eighth request (reserves {reserve})")
    kernels = _all_kernels()
    for k in kernels:
        k.launches = 0
    # -- the main path: both loops, then request 0 alone ----------------
    results = {}
    for mode, kw in (("dense", {}), ("paged", dict(paged=True, page_size=PAGE,
                                                   num_pages=1 + usable))):
        torch.cuda.reset_peak_memory_stats()
        timed = _Timed(model)
        loop = ServeLoop(timed, SLOTS, device=dev, **kw)
        kv = sum(paged_hbm_bytes(c) if mode == "paged" else kv_cache_bytes(c)
                 for c in loop.caches)
        outputs, deferred, wall = _serve_all(loop, reqs)
        stats = _loop_stats(timed, wall, torch.cuda.max_memory_allocated(), kv, deferred)
        if mode == "paged":
            for c in loop.caches:
                if (int(c.free_top) != usable or int(c.lengths.abs().sum())
                        or int(c.page_table.abs().sum())):
                    fail(f"paged loop: pages did not all return ({int(c.free_top)} of {usable} "
                         f"free)")
            if not deferred:
                fail("paged loop: no admission was deferred")
        results[mode] = (outputs, stats)
        del loop
        torch.cuda.empty_cache()
    iso = model.generate(torch.tensor(reqs[0].prompt, device=dev), NEW_TOKENS).tolist()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    # ------------------------------------------------------------------
    dense_out, dense = results["dense"]
    paged_out, paged = results["paged"]
    for rid in dense_out:
        if dense_out[rid] != paged_out[rid]:
            fail(f"request {rid}: dense loop {dense_out[rid]}, paged loop {paged_out[rid]}")
    if iso != dense_out[0]:
        fail(f"request 0 ({lens[0]} prompt tokens) served {dense_out[0]} but alone {iso}")
    per_fwd = 4 * cfg.n_layers + 1
    want = {k.__name__: 0 for k in kernels}
    want.update(
        int4_matmul_grouped_hl8=per_fwd * (dense["decode_steps"] + dense["prefills"]
                                           + paged["decode_steps"] + paged["prefills"]
                                           + NEW_TOKENS),
        decode_attend_q8kv_blocked_cur=cfg.n_layers * dense["decode_steps"],
        paged_decode_attend_cur=cfg.n_layers * paged["decode_steps"],
        decode_attend_q8kv_blocked=cfg.n_layers * (NEW_TOKENS - 1),
    )
    if launches != want:
        fail(f"long-context launch counts {launches}, expected {want}")
    report["serve_long"] = dict(card=card, prompt_lens=[int(n) for n in lens],
                                pool_pages=1 + usable, dense=dense, paged=paged,
                                launches=launches)
    for mode, st in (("dense", dense), ("paged", paged)):
        log(f"serve_long {mode}: {st['decode_steps']} decode steps, {st['prefills']} prefills "
            f"({st['prefill_s']:.2f} s, longest {st['prefill_max_s']:.2f} s, the "
            f"{LONG_PROMPTS[0]}-token prompt {st['prefill_long_s']:.3f} s); decode "
            f"{st['decode_tok_per_s']:.1f} tok/s, step median {st['step_ms_median']:.2f} ms, "
            f"max {st['step_ms_max']:.2f} ms; KV {st['kv_bytes'] / 1e9:.3f} GB; peak "
            f"{st['peak_gb']:.2f} GB; {st['deferred_admissions']} deferred admissions; "
            f"wall {st['wall_s']:.2f} s ({card})")
    log(f"serve_long: all {N_REQUESTS} requests equal in both loops; request 0 "
        f"({lens[0]} prompt tokens) equals its isolated generate run; every page back; "
        f"launches {launches}")
    if profile_dir is not None:  # the first eight requests, both long ones among them
        for mode, kw in (("dense", {}), ("paged", dict(paged=True, page_size=PAGE))):
            profile_decode(model, dev, reqs, report, profile_dir, f"profile_long_{mode}", **kw)
    return launches


# ---------------------------------------------------------------- phase 12


def check_k2(dev, gen, report):
    """K2 against its twin, bit for bit: the public wrapper in the regime
    ``_k1_regime`` picks, and each regime forced. The library yardstick is
    ``torch._int_mm`` over sign codes made beforehand: the integer product
    only, without K2's sign and its alpha epilogue (N padded to what
    ``_int_mm`` takes). Device times come at the end of phase 12."""
    from micronet_tpu_torch.ops import _build
    from micronet_tpu_torch.ops import int_matmul as i8

    out_cases = {}
    for label, m, k, n, iters in K2_CASES:
        args = k2_args(label, m, k, n, dev, gen)
        regime = i8._k1_regime(m, k, n, _build.sm_count(dev))
        err = check_int8_call(f"K2 {label} M={m} K={k} N={n}", i8.binary_act_matmul,
                              i8.binary_act_matmul_ref, True, args, regime)
        ms = time_ms(i8.binary_act_matmul, [args], iters)
        plain = time_ms(i8.binary_act_matmul_ref, [args], max(3, iters // 20), 1)
        codes = torch.where(args[0] >= 0, 1, -1).to(torch.int8)
        lib = time_ms(torch._int_mm, [int_mm_args(codes, args[1])], iters)
        bound, bound_by = int8_bound(m, k, n)
        out_cases[label] = dict(m=m, k=k, n=n, ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bound, bound_by=bound_by, max_abs_err=err, regime=regime)
        log(f"K2 {label:6s} M={m:6d} K={k:5d} N={n:5d} (regime {regime}): wrapper, small and "
            f"gemm regimes equal to the twin; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch._int_mm on sign codes {lib:.4f} ms, bound {bound:.4f} ms ({bound_by})")
        del args, codes
    torch.cuda.empty_cache()
    report["k2_cases"] = out_cases
    return out_cases


def check_k8_k9(dev, gen, report):
    """K8 (per-column scales) and K9 (group 128) against their twins at the
    five W4 shapes of one Llama-3-8B decode step, with copies of the weights
    larger than L2 together so each launch finds its weights cold. The
    library yardstick is ``torch.matmul`` on the dequantized bf16 weight."""
    from micronet_tpu_torch.ops import int4_matmul as im

    cases = {"int4_matmul": {}, "int4_matmul_grouped": {}}
    for (k, n), per_step in K3_SHAPES:
        ncopy = copies_for(k // 2 * n + k // GROUP * n * 4)
        packed = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=dev,
                                generator=gen) for _ in range(ncopy)]
        scales = {
            "int4_matmul": [torch.rand((n,), device=dev, generator=gen) * 0.01 + 1e-3
                            for _ in range(ncopy)],
            "int4_matmul_grouped": [torch.rand((k // GROUP, n), device=dev, generator=gen) * 0.01
                                    + 1e-3 for _ in range(ncopy)],
        }
        for name, fn, twin in (("int4_matmul", im.int4_matmul, im.int4_matmul_ref),
                               ("int4_matmul_grouped", im.int4_matmul_grouped,
                                im.int4_matmul_grouped_ref)):
            nlib = copies_for(2 * k * n)
            if name == "int4_matmul":
                w_bf16 = [(im.unpack_int4(p).float() * s).to(torch.bfloat16)
                          for p, s in zip(packed[:nlib], scales[name])]
            else:
                w_bf16 = [im._dequant_grouped_bf16(p, s, GROUP).to(torch.bfloat16)
                          for p, s in zip(packed[:nlib], scales[name])]
            for m in WO_MS:
                x = torch.randn((m, k), device=dev, generator=gen)
                args = [(x, p, s) for p, s in zip(packed, scales[name])]
                out = fn(*args[0])
                ref = twin(*args[0])
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                mag = ref.abs().max().item()
                if not (torch.isfinite(out).all() and err <= WO_REL_TOL * mag):
                    fail(f"{name} M={m} K={k} N={n}: max|err| {err:.3e} > {WO_REL_TOL} * "
                         f"{mag:.3e}")
                ms = time_ms(fn, args, 30)
                plain = time_ms(twin, args, 5, 1)
                lib_args = [(x.to(torch.bfloat16), w) for w in w_bf16]
                lib = time_ms(torch.matmul, lib_args, 30)
                dev_ms, lib_dev_ms = device_ms(fn, args, 30), device_ms(torch.matmul, lib_args, 30)
                scale_bytes = n * 4 if name == "int4_matmul" else k // GROUP * n * 4
                nbytes = m * k * 4 + k // 2 * n + scale_bytes + m * n * 4
                ops = 2 * m * k * n
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
                cases[name][(m, k, n)] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations", max_abs_err=err,
                    ref_max=mag, per_step=per_step, device_ms=dev_ms, library_device_ms=lib_dev_ms)
                log(f"{name:19s} M={m:3d} K={k:6d} N={n:6d}: err {err:.3e} (tol "
                    f"{WO_REL_TOL * mag:.3e}) kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
                    f"{plain:.4f} ms, torch.matmul bf16 {lib:.4f} ms (device {lib_dev_ms:.4f}), "
                    f"bound {cases[name][(m, k, n)]['bound_ms']:.4f} ms")
            del w_bf16
        del packed, scales
        torch.cuda.empty_cache()
    rows = {}
    for name, by_shape in cases.items():
        report[f"{name}_cases"] = [dict(m=m, k=k, n=n, **v) for (m, k, n), v in by_shape.items()]
        # the kernels line: one decode step's worth of calls at M = 8 (129)
        step = [v for (m, _, _), v in by_shape.items() if m == 8]
        rows[name] = dict({key: sum(v[key] * v["per_step"] for v in step)
                           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                                       "library_device_ms")},
                          max_abs_err=max(v["max_abs_err"] for v in by_shape.values()),
                          bound_by="bytes" if all(v["bound_by"] == "bytes" for v in step)
                          else "operations")
    return rows


# ---------------------------------------------------------------- phase 13


def _block_parts(layer, h):
    """(pre-activation, output) of one NIN-GC block on the NCHW ``h``."""
    from micronet_tpu_torch.nn import functional as F

    if not hasattr(layer, "conv"):
        out = layer(h)
        return out, out
    if layer.channel_shuffle_flag:
        h = F.channel_shuffle(h, layer.shuffle_groups)
    pre = layer.bn(layer.conv(h))
    return pre, layer.relu(pre)


def _card_vs_cpu(name, engine, x):
    """The engine on the card against a copy on the CPU, on ``x``: the first
    block's pre-sign output (an f32 conv) within F32_ROUTE_RTOL, with its
    sign flips counted; then both run the rest from the card's signs:
    every later block, the ternary convs' outputs included, bit for bit
    up to the classifier, which (a float conv, then the average pool) must
    agree within CLASSIFIER_RTOL."""
    import copy

    from micronet_tpu_torch.infer.engine import TernaryConv2d

    cpu = copy.deepcopy(engine).to("cpu")
    layers, cpu_layers = list(engine.model.layers), list(cpu.model.layers)
    h = x.permute(0, 3, 1, 2)
    pre, signs = _block_parts(layers[0], h)
    pre_cpu, signs_cpu = _block_parts(cpu_layers[0], h.cpu())
    pre_err = (pre.cpu() - pre_cpu).abs().max().item()
    if pre_err > F32_ROUTE_RTOL * pre_cpu.abs().max().item():
        fail(f"{name}: first block on the card vs the CPU, max|diff| {pre_err:.3e}")
    flips = int((signs.cpu() != signs_cpu).sum())
    h_card, h_cpu = signs, signs.cpu()
    ternary = 0
    for i, (lc, lh) in enumerate(zip(layers[1:], cpu_layers[1:]), start=1):
        (p_card, h_card), (p_cpu, h_cpu) = _block_parts(lc, h_card), _block_parts(lh, h_cpu)
        if i < len(layers) - 2:
            if not (torch.equal(p_card.cpu(), p_cpu) and torch.equal(h_card.cpu(), h_cpu)):
                fail(f"{name}: block {i} on the card differs from the CPU from the same signs "
                     f"(max|diff| {(p_card.cpu() - p_cpu).abs().max().item():.3e})")
            ternary += isinstance(getattr(lc, "conv", None), TernaryConv2d)
    logits, logits_cpu = h_card.reshape(x.shape[0], -1).cpu(), h_cpu.reshape(x.shape[0], -1)
    err = (logits - logits_cpu).abs().max().item()
    if err > CLASSIFIER_RTOL * max(1.0, logits_cpu.abs().max().item()):
        fail(f"{name}: logits on the card vs the CPU from the same signs, max|diff| {err:.3e}")
    return dict(first_block_max_abs=pre_err, first_block_flips=flips,
                first_block_values=signs.numel(), ternary_layers_equal=ternary,
                logits_max_abs=err)


@torch.no_grad()
def wbwtab_path(W, dev, seed, report, profile_dir=None):
    """Slice 4's main path at one weight width: NIN-GC at full width,
    ``prepare(method="wbwtab")``, BN statistics from 4 train-mode forwards,
    ``fuse_bn_wbwtab``, ``freeze_wbwtab``, then the engine at batch 1024."""
    import copy

    from micronet_tpu_torch.infer import freeze_wbwtab, fuse_bn_wbwtab
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    name = f"nin_gc_wbwtab_w{W}"
    cfg = QuantConfig(W=W, A=2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = Net(device=dev, generator=gen)
    fp32 = eval_mode(copy.deepcopy(model))
    q = train_mode(prepare(model, cfg, method="wbwtab", device=dev))
    for _ in range(CALIB_STEPS):
        q(torch.randn((CALIB_BATCH, 32, 32, 3), device=dev, generator=gen))
    fused = eval_mode(fuse_bn_wbwtab(eval_mode(q), cfg, device=dev))
    engine = eval_mode(freeze_wbwtab(fused, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_ternary = sum(type(m).__name__ == "TernaryConv2d" for m in engine.modules())
    if n_ternary != 7:
        fail(f"{name}: {n_ternary} TernaryConv2d, expected 7")
    x = torch.randn((NIN_BATCH, 32, 32, 3), device=dev, generator=gen)

    kernels = _all_kernels()
    for kern in kernels:
        kern.launches = 0
    # -- the main path: engine forwards --------------------------------
    out = engine(x)
    engine_ms = _forward_ms(engine, x, ENGINE_ITERS)
    launches = {kern.__name__: kern.launches for kern in kernels}
    # ------------------------------------------------------------------
    if any(launches.values()):
        fail(f"{name}: launch counts {launches}, expected none (no kernel on this path)")
    if tuple(out.shape) != (NIN_BATCH, 10) or not torch.isfinite(out).all():
        fail(f"{name}: engine output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    fp32(x)
    fp32_ms = _forward_ms(fp32, x, ENGINE_ITERS)
    fq = fused(x)
    fused_ms = _forward_ms(fused, x, ENGINE_ITERS)
    agree = (out.argmax(-1) == fq.argmax(-1)).float().mean().item()
    if profile_dir is not None:
        report[f"{name}_profile"] = trace(lambda: engine(x), 3, f"{name} engine forwards",
                                          profile_dir / f"chip_smoke_{name}_profile.txt")
    cmp = _card_vs_cpu(name, engine, x[:CPU_BATCH])
    res = dict(batch=NIN_BATCH, W=W, setup_s=setup_s, ternary_layers=n_ternary,
               launches=launches, forwards=1 + ENGINE_ITERS, engine_ms=engine_ms,
               engine_img_s=NIN_BATCH / engine_ms * 1e3, fp32_ms=fp32_ms,
               fp32_img_s=NIN_BATCH / fp32_ms * 1e3, fused_ms=fused_ms,
               fused_img_s=NIN_BATCH / fused_ms * 1e3, top1_agree_with_fused=agree,
               max_abs_vs_fused=(out - fq).abs().max().item(), cpu_rows=CPU_BATCH, **cmp,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    report[name] = res
    log(f"{name}: setup {setup_s:.1f} s, {n_ternary} TernaryConv2d; engine at batch "
        f"{NIN_BATCH}: {engine_ms:.2f} ms = {res['engine_img_s']:.0f} img/s, port fp32 eval "
        f"(TF32 off) {fp32_ms:.2f} ms = {res['fp32_img_s']:.0f} img/s, fused float model "
        f"{fused_ms:.2f} ms = {res['fused_img_s']:.0f} img/s; top-1 agreement with the fused "
        f"model {agree:.4f}; launches {launches}")
    log(f"{name}: on {CPU_BATCH} images, first block card vs CPU max|diff| "
        f"{cmp['first_block_max_abs']:.3e}, {cmp['first_block_flips']} of "
        f"{cmp['first_block_values']} signs flipped; from the card's signs every later block "
        f"({cmp['ternary_layers_equal']} ternary convs) equal bit for bit, logits within "
        f"{cmp['logits_max_abs']:.3e}")
    return launches


def wbwtab_engine(dev, seed, report, profile_dir=None):
    """Both weight widths; the launch counts summed over both runs."""
    runs = [wbwtab_path(W, dev, seed, report, profile_dir) for W in WBWTAB_W]
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 5 decode steps of each serving loop and 3 forwards "
                         "of each engine with torch.profiler")
    ap.add_argument("--out", type=Path, default=Path("build/chip_smoke"),
                    help="directory for the JSON report and the profile table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from micronet_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    built = _build.build_all()
    log(f"build: {built['seconds']:.1f} s")
    for name in _build.SOURCES:
        text = Path(built[name]).with_suffix(".log").read_text(errors="replace")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", text))
        log(f"  {name}: {len(regs)} kernels, registers {min(regs)}..{max(regs)}, "
            f"{spills} bytes of spill stores and loads")

    report = {"card": card, "torch": torch.__version__, "seed": args.seed}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k3 = check_k3(dev, gen, report)
    att = check_attention(dev, gen, report)
    report["reference_max_abs"] = check_reference(dev)
    out_dir = args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    profile_dir = out_dir if args.profile else None
    launches = serve(dev, args.seed, report, profile_dir)
    k1 = check_k1(dev, gen, report)
    check_conv_routes(dev, gen, report)
    # each kernel's count from its own slice's main path
    launches["int8_matmul_dequant"] = resnet_engine(dev, args.seed, report,
                                                    profile_dir)["int8_matmul_dequant"]
    nin_engine(dev, args.seed, report, profile_dir)
    long_att = check_long_attention(dev, gen, report)
    launches.update({k: v for k, v in serve_long(dev, args.seed, card, report,
                                                 profile_dir).items()
                     if k in LONG_KERNELS})
    k2 = check_k2(dev, gen, report)
    wo = check_k8_k9(dev, gen, report)
    k3_device_times(dev, gen, report, k3)
    attention_device_times(dev, gen, report, att, long_att)
    k1_row = {k: v for k, v in k1["path"].items()
              if k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    k2_row = {k: v for k, v in k2["path"].items()
              if k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    int8_device_times(dev, gen, report, k1_row, k2_row)
    launches.update({k: v for k, v in wbwtab_engine(dev, args.seed, report, profile_dir).items()
                     if k in WBWTAB_KERNELS})

    src = "micronet_tpu_torch/ops/csrc/"
    long_per = (f"one call, G={ATT_G} R={ATT_R} D={ATT_D} S={LONG_CTX}, bounds 0..{LONG_CTX}")
    paged_per = (f"one call, {SLOTS} slots x {ATT_G // SLOTS} KV heads, R={ATT_R}, pages of "
                 f"{PAGE}, S={LONG_CTX}, lengths 0..{LONG_CTX}; library_ms is SDPA on the "
                 f"gathered bf16 view, the gather not timed")
    rows = [
        dict(name="int4_matmul_grouped_hl8", route="cuda", source=src + "int4_matmul.cu",
             replaces="micronet_tpu/ops/int4_matmul.py:548",
             launches=launches["int4_matmul_grouped_hl8"],
             per="one decode step at M=8: 129 calls over the five 8B shapes", **k3),
        dict(name="decode_attend_q8kv_cur", route="cuda", source=src + "decode_attention.cu",
             replaces="micronet_tpu/ops/decode_attention.py:519",
             launches=launches["decode_attend_q8kv_cur"],
             per=f"one call, G={ATT_G} R={ATT_R} D={ATT_D} S={ATT_S}",
             **att["decode_attend_q8kv_cur"]),
        dict(name="decode_attend_q8kv", route="cuda", source=src + "decode_attention.cu",
             replaces="micronet_tpu/ops/decode_attention.py:107",
             launches=launches["decode_attend_q8kv"],
             per=f"one call, G={ATT_G} R={ATT_R} D={ATT_D} S={ATT_S}",
             **att["decode_attend_q8kv"]),
        dict(name="int8_matmul_dequant", route="cuda", source=src + "int_matmul.cu",
             replaces="micronet_tpu/ops/int_matmul.py:114",
             launches=launches["int8_matmul_dequant"],
             per="one call at M=512 K=512 N=10 (ResNet-18's fc at batch 512); library_ms is "
                 "torch._int_mm on codes quantized beforehand: the integer product only",
             **k1_row),
        dict(name="decode_attend_q8kv_blocked_cur", route="cuda",
             source=src + "decode_attention.cu",
             replaces="micronet_tpu/ops/decode_attention.py:390",
             launches=launches["decode_attend_q8kv_blocked_cur"], per=long_per,
             **long_att["decode_attend_q8kv_blocked_cur"]),
        dict(name="decode_attend_q8kv_blocked", route="cuda", source=src + "decode_attention.cu",
             replaces="micronet_tpu/ops/decode_attention.py:233",
             launches=launches["decode_attend_q8kv_blocked"], per=long_per,
             **long_att["decode_attend_q8kv_blocked"]),
        dict(name="paged_decode_attend_cur", route="cuda", source=src + "paged_attention.cu",
             replaces="micronet_tpu/ops/paged_attention.py:306",
             launches=launches["paged_decode_attend_cur"], per=paged_per,
             **long_att[f"paged_decode_attend_cur_page{PAGE}"]),
        dict(name="paged_decode_attend", route="cuda", source=src + "paged_attention.cu",
             replaces="micronet_tpu/ops/paged_attention.py:131",
             launches=launches["paged_decode_attend"], per=paged_per,
             **long_att[f"paged_decode_attend_page{PAGE}"]),
        dict(name="binary_act_matmul", route="cuda", source=src + "int_matmul.cu",
             replaces="micronet_tpu/ops/int_matmul.py:201",
             launches=launches["binary_act_matmul"],
             per=f"one call at M={K2_CASES[0][1]} K={K2_CASES[0][2]} N={K2_CASES[0][3]} "
                 "(NIN-GC's 8th conv as a dense GEMM at batch 1024); library_ms is "
                 "torch._int_mm on sign codes made beforehand: the integer product only",
             **k2_row),
        dict(name="int4_matmul", route="cuda", source=src + "int4_matmul.cu",
             replaces="micronet_tpu/ops/int4_matmul.py:158", launches=launches["int4_matmul"],
             per="129 calls at M=8 over the five 8B shapes (one decode step's worth)",
             **wo["int4_matmul"]),
        dict(name="int4_matmul_grouped", route="cuda", source=src + "int4_matmul.cu",
             replaces="micronet_tpu/ops/int4_matmul.py:309",
             launches=launches["int4_matmul_grouped"],
             per="129 calls at M=8 over the five 8B shapes (one decode step's worth), group 128",
             **wo["int4_matmul_grouped"]),
    ]
    report["kernels"] = rows
    report["device_ms_retries"] = TRACE_RETRIES
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"total {report['seconds']:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
