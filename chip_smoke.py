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
   989 TFLOP/s);
4. reference: a small Llama with head_dim 128 served on the card and on
   the CPU (where the wrappers run their twins), logits compared;
5. serve (the main path): ``Llama(llama3_8b(2048), w4_group=128)`` with
   random weights from a seeded generator, 12 greedy requests through
   ``ServeLoop(max_slots=8)``, then one request again through
   ``Llama.generate`` alone, which must give the same tokens; the
   kernels' launch counts, reset just before and read just after, must
   show every kernel ran as often as the path calls it;
6. with ``--profile``, a traced run of 5 decode steps at 8 busy slots
   (``torch.profiler``): device busy share and kernel time by name;
7. the kernels line (JSON), then the final line
   ``{"ok": true, "device": {...}}``.

Details of every measurement go to ``<out>/chip_smoke.json`` (``--out``,
default ``build/chip_smoke``).
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20
GROUP = 128
# (K, N) of each W4 projection of one Llama-3-8B block, and the lm_head,
# with how many times one decode step calls it
K3_SHAPES = [((4096, 6144), 32), ((4096, 4096), 32), ((4096, 28672), 32),
             ((14336, 4096), 32), ((4096, 128256), 1)]
K3_MS = (1, 8, 128)
ATT_G, ATT_R, ATT_D, ATT_S = 64, 4, 128, 2048  # 8 slots x 8 KV heads
# exact products, f32 sums in another order over up to 14336 terms
K3_REL_TOL = 2e-5
# sums in another order; a term p * v_scale within an ulp of a bf16
# rounding boundary may round to the neighbouring bf16 value
ATT_ABS_TOL = 1e-3
# logits of a whole model: an activation may cross a bf16 rounding
# boundary before a W4 matmul (2^-8 relative on that term)
MODEL_REL_TOL = 1e-2
N_REQUESTS, SLOTS, NEW_TOKENS = 12, 8, 32


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


def copies_for(nbytes: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


# ---------------------------------------------------------------- phase 3


def check_k3(dev, gen, report):
    from micronet_tpu_torch.ops import int4_matmul as im

    cases = {}
    for (k, n), per_step in K3_SHAPES:
        packed_bytes = k // 2 * n + k // GROUP * n * 4
        ncopy = copies_for(packed_bytes)
        weights = []
        for _ in range(ncopy):
            packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                                   device=dev, generator=gen)
            gs = torch.rand((k // GROUP, n), device=dev, generator=gen) * 0.01 + 1e-3
            weights.append((packed, gs))
        # the library yardstick: one bf16 matmul on the dequantized weight
        w_bf16 = [(im.unpack_int4_hl8(p).float() * im.expand_gscale(g, GROUP))
                  .to(torch.bfloat16) for p, g in weights[: copies_for(2 * k * n)]]
        for m in K3_MS:
            x = torch.randn((m, k), device=dev, generator=gen)
            out = im.int4_matmul_grouped_hl8(x, *weights[0])
            ref = im.int4_matmul_grouped_hl8_ref(x, *weights[0])
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not (torch.isfinite(out).all() and err <= K3_REL_TOL * scale):
                fail(f"K3 M={m} K={k} N={n}: max|err| {err:.3e} > {K3_REL_TOL} * {scale:.3e}")
            xb = x.to(torch.bfloat16)
            ms = time_ms(im.int4_matmul_grouped_hl8, [(x, p, g) for p, g in weights], 30)
            plain = time_ms(im.int4_matmul_grouped_hl8_ref, [(x, p, g) for p, g in weights], 5, 1)
            lib = time_ms(torch.matmul, [(xb, w) for w in w_bf16], 30)
            nbytes = m * k * 4 + packed_bytes + m * n * 4
            ops = 2 * m * k * n
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            cases[(m, k, n)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                    bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S else "operations",
                                    max_abs_err=err, ref_max=scale, per_step=per_step)
            log(f"K3 M={m:4d} K={k:6d} N={n:6d}: err {err:.3e} (tol {K3_REL_TOL * scale:.3e}) "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul bf16 {lib:.4f} ms, "
                f"bound {bound:.4f} ms ({cases[(m, k, n)]['bound_by']})")
        del weights, w_bf16
        torch.cuda.empty_cache()
    report["k3_cases"] = [dict(m=m, k=k, n=n, **v) for (m, k, n), v in cases.items()]
    # the kernels line reports one decode step at M = 8 (129 calls)
    step = [v for (m, _, _), v in cases.items() if m == 8]
    summed = {key: sum(v[key] * v["per_step"] for v in step)
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(summed, max_abs_err=max(v["max_abs_err"] for v in cases.values()),
                bound_by="bytes" if all(v["bound_by"] == "bytes" for v in step) else "operations")


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
        # library yardstick: SDPA over the dequantized bf16 cache (with the
        # current row appended for the _cur form), bounds as a mask
        n_vis = bound.to(torch.int64) + (1 if extra else 0)
        kc, ks, vc, vs = caches[0]
        kf = (kc.float() * ks[..., None]).to(torch.bfloat16)
        vf = (vc.float() * vs[..., None]).to(torch.bfloat16)
        if extra:
            kf = torch.cat([kf, (cur[0].float() * cur[1][:, None]).to(torch.bfloat16)[:, None]], 1)
            vf = torch.cat([vf, (cur[2].float() * cur[3][:, None]).to(torch.bfloat16)[:, None]], 1)
            pos = torch.arange(s + 1, device=dev)
            mask = (pos[None, :] < bound[:, None]) | (pos[None, :] == s)
        else:
            mask = torch.arange(s, device=dev)[None, :] < bound[:, None]
        mask = mask[:, None, :].expand(g, r, mask.shape[-1])
        qb = q.to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = time_ms(lambda a, b, c, m: sdpa(a, b, c, attn_mask=m), [(qb, kf, vf, mask)], 50)
        vis = n_vis.sum().item()
        nbytes = (vis * (2 * d + 8) + g * r * d * 4 * 2 + g * 4)
        ops = 4 * r * d * vis
        bnd = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                         bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S else "operations",
                         max_abs_err=err)
        log(f"{name} G={g} R={r} D={d} S={s} (bounds 1..{s}, {vis} visible rows): "
            f"err {err:.3e} (tol {ATT_ABS_TOL}), kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa bf16 {lib:.4f} ms, bound {bnd:.4f} ms")
    report["attention"] = out
    del caches
    torch.cuda.empty_cache()
    return out


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
        self.decode_s, self.prefill_s = [], []

    def __getattr__(self, name):
        return getattr(self._m, name)

    def _time(self, fn, sink, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    def forward(self, *a):
        return self._time(self._m.forward, self.prefill_s, *a)

    def decode_batch(self, *a):
        return self._time(self._m.decode_batch, self.decode_s, *a)


def profile_decode(model, dev, reqs, report, out_dir: Path):
    """A traced run (``torch.profiler``) of 5 decode steps with all 8
    slots busy: the device's busy share of the wall time and the kernel
    time by name. Tracing adds host time, so the untraced step time above
    is the end-to-end figure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from micronet_tpu_torch.serve import Request, ServeLoop

    loop = ServeLoop(model, SLOTS, device=dev)
    for r in reqs[:SLOTS]:
        loop.submit(Request(1000 + r.rid, r.prompt, NEW_TOKENS))
    loop.step()  # admits every slot
    loop.step()
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loop.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: an operator's row repeats the time of the kernels it launched
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    (out_dir / "chip_smoke_profile.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    res = dict(steps=steps, wall_s=wall, device_busy_s=device_s,
               busy_share=device_s / wall,
               by_kernel=[dict(name=e.key, calls=e.count,
                               device_ms=e.self_device_time_total / 1e3) for e in top])
    report["profile"] = res
    log(f"profile: {steps} decode steps at {SLOTS} busy slots, traced wall "
        f"{1e3 * wall / steps:.2f} ms/step, device busy {1e3 * device_s / steps:.2f} ms/step "
        f"({100 * device_s / wall:.1f}% busy)")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:9.3f} ms/step  {e.count // steps:6d} "
            f"calls/step  {e.key[:90]}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 5 decode steps with torch.profiler")
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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    report = {"card": card, "torch": torch.__version__, "seed": args.seed}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k3 = check_k3(dev, gen, report)
    att = check_attention(dev, gen, report)
    report["reference_max_abs"] = check_reference(dev)
    out_dir = args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = serve(dev, args.seed, report, out_dir if args.profile else None)

    src = "micronet_tpu_torch/ops/csrc/"
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
    ]
    report["kernels"] = rows
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
