#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``micronet_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--profile] [--out DIR] [--slice12]

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
   of the decode-attention kernel the card holds at once. K3 also at
   M = 136 (regime B at decode: phase 24's loop past 128 slots; the
   kernels line's ``m136_*``);
4. reference: a small Llama with head_dim 128 served on the card and on
   the CPU (where the wrappers run their twins), logits compared;
5. serve (slice 1's main path): ``Llama(llama3_8b(2048), w4_group=128)`` with
   random weights from a seeded generator, 12 greedy requests through
   ``ServeLoop(max_slots=8)``, then one request again through
   ``Llama.generate`` alone, which must give the same tokens; the
   kernels' launch counts, reset just before and read just after, must
   show every kernel ran as often as the path calls it; phase 24 follows
   on the same model;
6. with ``--profile``, a traced run of 5 decode steps at 8 busy slots
   (``torch.profiler``): device busy share and kernel time by name (and
   the same for 3 forwards of each engine in phases 9, 13, 16 and 17, and
   for both loops of phase 11, and 5 decode steps of each TinyDecoder
   form in phase 18); the traces of phases 6, 9 and 11 are
   taken after phase 12's device readings (after a traced serving run,
   those readings' traces lost kernels);
7. K1 (``int8_matmul_dequant``) against its twin, bit for bit, at the
   engine's call, ResNet-50's fc (512 x 2,048 x 10) and LeNet's first
   Linear at batch 1,024 (1,024 x 400 x 120) (phase 23's calls), a large
   call and a ragged A4 call with zp != 0: the
   public wrapper in the regime ``_k1_regime`` picks (logged) and each of
   its two regimes forced (the small mma.sync kernel, the wgmma GEMM with
   its pre-passes), timed beside ``torch._int_mm`` on codes and its int8
   bound (1,979 TOP/s); its device times come at the end of phase 12;
8. conv routes: every IntConv2d route at ResNet-18's and NIN-GC's layer
   shapes; the int32 accumulators equal an f64 conv of the same codes;
9. engine (slice 2's main path): ``resnet18()`` with seeded random
   weights, ``prepare`` W8A8 with fused BN (``EXACT``, as in phases 16,
   17 and 19: the fake-quant models these hold the engines against run
   the exact path), 4 calibration forwards at
   batch 64, ``fuse_bn_iao``, ``freeze_int``, engine forwards at batch
   512; K1 must launch once per forward and the conv epilogue
   (``ops/requant_epilogue.py``) once per symmetric conv, 20 (counts
   zeroed just before, read just after); the same engine on the CPU must
   agree on 8 images; img/s of the engine and of the port's fp32 eval.
   Then the same for NIN-GC W4A4 at batch 1024 (K1 not on that path; the
   epilogue 9 times a forward). In both, every symmetric conv's
   accumulator rows from one forward (its input kept by a hook) through
   the conv epilogue's wrapper and its twin on the card: equal bit for
   bit (f32 outputs as int32), the strided 10-of-16 slice of NIN-GC's
   last conv too. The patch gathers (``ops/patch_gather.py``) launch 20
   and 9 times a forward (ResNet-18: the stem's f32 patches, 16 3 x 3
   convs, 3 strided shortcuts; NIN-GC: the stem, two 3 x 3 convs, six
   int8 shuffles), and each call of one forward, on its own input (kept
   by wrapping the engine's calls), equals its twin bit for bit and reads
   NHWC-backed codes (no NHWC copy);
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
   forced) beside ``torch._int_mm``'s on codes, and the conv epilogue's
   at every symmetric conv of phase 9's engines beside its twin's and
   the bytes bound, M x O x (4 + 1) for int8 out and x (4 + 4) for f32
   (the kernels line's ``requant_epilogue`` row), and the patch gathers'
   at every call of phase 9's and 25's engines beside their twins' and
   the bytes bound, the input read once and the output written once (the
   ``patch_gather`` row; after the serving
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
14. training (slice 5's main path) through ``micronet_tpu_torch.cli``:
   ``train`` on ``nin_gc.Net()`` at full width, batch 256, 2 epochs of 8
   steps on the synthetic set, for ``float``, ``iao --bn_fuse``,
   ``dorefa``, ``wbwtab --W 3 --A 2`` and ``wbwtab --W 2 --A 2`` (the
   CLI's wbwtab default, binary weights), IAO and DoReFa through the
   default ``"auto"`` training lowerings (bf16 code operands; IAO's batch
   statistics from the quantized conv's accumulator) (no hand-written
   kernel: every count 0; each method's last loss below its first; img/s
   with the run's first step left out, step times, peak memory, losses and
   test accuracy on a line of their own), ``model-test`` on the IAO
   checkpoint (EQUIVALENCE OK, both models lowered) and on the binary
   wbwtab one, each method's
   ``train`` again with the same seed (the same checkpoint, array for
   array: the trainer's steps run cuDNN's deterministic algorithms), then
   each method's step at batch 8 on the card against the CPU, block by
   block from the CPU's inputs (TF32 off), on the exact path
   (``EXACT``: the lowerings pinned off on both sides);
15. ``cli train --ptq --ptq_observer kl --calib_cache`` on full-width
   ResNet-18, ``cli freeze-int``, the engine at batch 512 (K1 once per
   forward, the card against the CPU on 8 images); then NIN's ``train -sr``
   -> ``prune --percent 0.5`` -> ``train --prune_quant``, the first two
   twice with the same seed (the same checkpoints and pruned widths);
16. the asymmetric engine (slice 6's main path): the ACC_TABLE recipe
   ``iao_w4a4_asym_fl8`` (``q_type=1``, W4A4, first and last layers at 8
   bits, BN folded). ``cli train`` on full-width NIN-GC (8 steps at batch
   256), ``cli freeze-int`` with the same flags, the engine rebuilt from
   the checkpoint (equal to the saved one key for key) at batch 1024,
   within QUANT_ATOL of its fake-quant model; then full-width ResNet-18
   through phase 9's engine path at batch 512 (its fc an asymmetric
   ``IntLinear``: K1 launches 0 times). Both: no hand-written kernel on
   the path (every count 0); on 8 images the card equal to the CPU layer
   by layer, each asymmetric accumulator within its f32 rounding of the
   exact integer value (``engine.exact_zero_point_acc``); img/s beside
   phase 9's symmetric engine of the same model and the fp32 eval;
17. ConvTranspose and Concat: the transposed-conv route against f64
   ``conv_transpose2d`` at five shapes, then UpNet (conv, stride-2
   transposed conv, 1x1 conv) and the concat net at 32 x 32, q_type 0 and
   1, engines at batch 256: card = CPU layer by layer, within QUANT_ATOL
   of the fake-quant model, the symmetric concat net's three chained
   modules;
18. TinyDecoder serving (slice 7's main path): ``examples/serve_llm.py``'s
   configuration (vocab 256, dim 128, 8 heads, depth 4, MLP 256, max_seq
   64), dense and MoE (8 int8 experts, top-1 and top-2), float and
   ``quantize_decoder(group=32)`` from one generator (the W4 logits'
   cosine against float); the W4 model behind ``ServeLoop(max_slots=4)``
   over six mixed-length requests, two arriving late: launch counts
   zeroed just before and read just after (per decode step per slot K3
   24 dense, 16 MoE, and K5a 4; K3 also per prefill), every request's
   tokens equal to its isolated ``generate`` bit for bit; the card
   against the same weights on the CPU under teacher forcing, and prefill
   against incremental decode on the card; decode tokens/s and step
   times. K3 and K5a against their twins at this path's shapes, timed
   (events and device time) beside the twin, one library call and the
   bound, run at the end of phase 12 with the other device readings;
19. deploy (slice 8's main path): phase 9's two engines behind
   ``build_engine`` (ResNet-18 W8A8 at profile (1, 64, 512), NIN-GC W4A4
   at (1, 256, 1024)): one CUDA graph per bucket; requests of 1, 5, 64,
   300, the largest bucket and 2.5x it (chunked) each equal to the eager
   engine bit for bit, and on 8 images to the engine on the CPU; the
   counts zeroed just before the buckets are built and read after the
   requests (K1 one launch per capture, none per replay), and by
   ``torch.profiler`` one K1 kernel in each ResNet-18 replay, none in
   NIN-GC's, and in each replay one conv epilogue kernel a symmetric conv
   (20 and 9), phase 9's patch gathers of a forward (20 and 9) and no
   other hand-written kernel; per bucket the eager
   forward's ms, the replay's, a call's img/s and the capture's seconds.
   The ResNet-18
   engine through ``serialize_engine`` at batch 512 and
   ``deserialize_engine`` (export, save and load seconds, bytes; its
   graph calls the K1 operator once and the conv epilogue's 20 times;
   bit-equal to the engine; a record naming
   another compute capability refused); ``to_bf16``/``bf16_runner`` on
   the float ResNet-18 (within 0.05 relative L2 of fp32, img/s beside
   fp32); ``cli train`` (2 steps) then ``cli deploy`` on ResNet-18, the
   artifact equal to the engine built from the checkpoint;
   ``profiling.current_chip()`` names the card, and with ``--profile``
   ``profiling.trace`` writes 3 replays of each largest bucket; then K1
   at phase 7's fc call through the operator, without it, and replayed.
   It runs after phase 12's device readings and before ``--profile``'s
   deferred traces (after those, its replay traces lost kernels);
20. the training lowerings (slice 9's main path is phase 14's ``"auto"``):
   each quantized layer of full-width NIN-GC (IAO ``--bn_fuse`` and
   DoReFa) lowered against the same layer on the exact path on the card
   (median relative deviation < 0.02, BN running statistics within rtol
   0.05, the JAX package's bounds); by ``torch.profiler``, one bf16
   forward convolution a ``QuantBNFuseConv2d`` in a lowered training step
   against two f32 ones on the exact path; phase 14's IAO and DoReFa
   ``cli train`` again with the config pinned to the exact path, each
   step's loss within rtol 0.05 and atol 0.01 of the lowered run's, img/s,
   step times and peak memory of both side by side; two ``remat=True``
   steps equal to two plain ones in every parameter, gradient and buffer
   (their ms and peak memory); ``graft_entry.entry()``'s forward twice on
   the card (the same bits) and against the CPU's exact path;
21. parallelism (slice 10's main path): one rank a card over NCCL, the
   world every card (``torch.multiprocessing``). On one card (a world of
   1, every collective launched): phase 14's IAO ``--bn_fuse`` epoch (8
   steps at batch 256) through ``Trainer(mesh=make_mesh(1, 1))`` equal to
   the trainer without a mesh bit for bit, and phase 19's ResNet-18 engine
   through ``build_engine(mesh=)`` (one bucket of 512, a CUDA graph) equal
   to its eager output bit for bit, K1 once per forward. On more cards, at
   dp = cards and at dp = cards / 2 x tp = 2: training img/s at global
   batch 256 and 1,024 beside rank 0 alone, two same-seed runs compared,
   the engine's eager and bucket img/s at 512 (bit for bit at dp), and
   with ``--profile`` the NCCL share of two traced steps. Then two ranks
   share card 0 over gloo: the DP step of full-width NIN-GC (exact path)
   at 2 x 128 against one process at 256, block by block (``PAR_RTOL``),
   and the engine at dp = 2 (bit for bit) and tp = 2 (within
   ``PAR_RTOL``);
22. serving parallelism (slice 11's main path), one rank a card as in
   phase 21. On one card a world of 1 over NCCL: the W4 Llama (4 blocks)
   behind ``ServeLoop(8)``, dense and paged, through ``shard_state`` over
   ``make_mesh(1, 1)`` equal to the unsharded loop bit for bit. Then two
   gloo ranks share card 0 (on four cards the NCCL ranks, at the full 32
   blocks): ``Llama(llama3_8b(2048), w4_group=128)`` cut to 4 blocks,
   sharded over ``model`` (every W4 projection and the W4 lm_head by
   column, K3 at N / tp), 12 requests of 16 to 256 prompt tokens and 16
   new tokens each through the dense and the paged ``ServeLoop(8)`` (page
   16) against the unsharded loops run first on rank 0 (the single-card
   numbers): logits within 1e-4 and tokens up to the first near tie, K3,
   K4a and K6 counted exactly; ``generate`` on one prompt (K5a); on four
   cards again at tp = 2 on a (2, 2) mesh. The W4 TinyDecoder of phase 18
   tensor-parallel behind ``ServeLoop(4)`` (K3 at N = 64 and 32, K5a), the
   same checks; its MoE form (8 int8 experts, top-1) with ``use_ep`` over
   ``expert`` against the dense path (2e-5), ``moe_apply_ep`` forward and
   backward and top-2 ``moe_apply_ep_a2a`` against their oracles (1e-5);
   ``prefill_sp`` of 64- and 32-token prompts over ``seq`` (zigzag; 2e-5,
   caches bit for bit, 16 decode steps from either cache bit for bit) and
   ring attention forward and backward (1e-5); ``pipeline_apply_stateful``
   over one stage a rank of NIN's seventh block (IAO W8A8 ``bn_fuse``,
   training mode, 2 x S microbatches of 64 on 8x8 maps) forward and
   backward against the sequential fold (loss 1e-3, gradients 1e-3 and
   state 1e-5 x max|.|), img/s and the bubble share beside the fold's.
   Then, in this process, K3 at one rank's column slices of an 8B decode
   step at tp = 2 and 4 (M = 8, ``split_cols`` the whole N) against its
   twin, timed beside the twin, ``torch.matmul`` and the bound;
23. BottleNeck and LeNet engines (slice 12): full-width ``resnet50()``
   (CIFAR stem, 10 classes) at batch 512 and ``LeNet()`` at batch 1,024
   through phase 9's engine path, W8A8 with fused BN (``EXACT``), phase
   9's cuts; K1 launches once per forward for each symmetric ``IntLinear``
   the engine holds (ResNet-50's fc at K = 2,048; LeNet's three Linears),
   read from the engine, and nothing else launches; the card equal to the
   CPU on 8 images (``CARD_CPU_TOL``) and to the fake-quant model
   (``FQ_TOL``); img/s beside the port's fp32 eval, chained layers, peak
   memory; with ``--profile``, 3 traced forwards each. It runs after phase
   9;
24. the serving loop's options (slice 12), on phase 5's model right after
   phase 5 (before phase 11 builds its own): phase 5's 12 requests
   through ``ServeLoop(8, prefill_chunk=64)``, dense and paged (page 16),
   against the unchunked loop run again with its logits kept (prompts up
   to 128 tokens: equal tokens; longer ones, whose whole prefill runs K3
   in regime B and whose chunks in A: logits within ``REGIME_REL_TOL``, a
   token differing only at a near tie; K3 129 a chunk forward); the same
   prompts with mixed sampling settings (``SAMPLING``, a seed each)
   through the dense loop twice and the paged loop, each stream equal to
   ``generate_sampled`` (greedy ones ``generate``) with the same settings
   on the card bit for bit, every token inside the set ``kept_tokens``
   gives on the logits it was drawn from (no card-vs-CPU token comparison:
   the card's generators draw other numbers than the CPU's from one
   seed); then ``ServeLoop(136)`` with 136 greedy requests (prompts of 16
   to 64 tokens, 8 new tokens), all admitted before the first decode step,
   every decode step in K3's regime B (its GEMM calls counted at
   M = 136), eight requests spread over the slots teacher-forced with
   ``generate``'s tokens and their logits held to ``generate``'s position by
   position; exact launch counts; decode step ms, tok/s and peak memory;
25. MobileNetV2 engine (the depthwise route): full-width
   ``mobilenet_v2()`` (CIFAR strides, 10 classes) through phase 9's
   engine path, W8A8 with fused BN (``EXACT``), at batch 1,024, the
   benchmark cell's; counts zeroed just before the engine forwards and
   read after: the depthwise kernel (``ops/dwconv.py``) 17 a forward, the
   conv epilogue 35, K1 once (the classifier), nothing else; the card
   equal to the CPU on 8 images (``CARD_CPU_TOL``) and to the fake-quant
   model (``MOBILENET_FQ_TOL``); each depthwise conv on its own int8
   input from one forward (kept by a hook) through the kernel, its twin
   and the block-diagonal route (im2col, the int32 GEMM over the
   block-diagonal weight, the conv epilogue): equal bit for bit (f32
   outputs as int32); every depthwise conv and projection reads int8
   codes; the patch gathers once a forward (the stem), equal to the twin.
   After phase 12's device readings, each layer's device time on
   the kernel and on the block-diagonal route beside its bound (the
   kernels line's ``dwconv_int8`` row). It runs after phase 23;
26. the kernels line (JSON), then the final line
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


def _load_chips():
    """``CHIPS`` of ``micronet_tpu_torch/utils/profiling.py``, loaded from
    its file: importing the package here would pin this checkout's
    ``micronet_tpu_torch`` before ``tools/*.py --tree`` put another
    checkout's first on the path."""
    import importlib.util

    path = Path(__file__).resolve().parent / "micronet_tpu_torch" / "utils" / "profiling.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_profiling", path)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CHIPS


CHIPS = _load_chips()

# the H100 SXM's published dense peaks (micronet_tpu_torch/utils/profiling.py)
_H100 = CHIPS["h100_sxm"]
HBM_BYTES_PER_S = _H100.hbm_gbps * 1e9  # 3.35 TB/s
BF16_OPS_PER_S = _H100.bf16_tflops * 1e12  # dense bf16 tensor-core peak
INT8_OPS_PER_S = _H100.int8_tops * 1e12  # dense int8 tensor-core peak
L2_BYTES = 50 * 2**20
GROUP = 128
# (K, N) of each W4 projection of one Llama-3-8B block, and the lm_head,
# with how many times one decode step calls it
K3_SHAPES = [((4096, 6144), 32), ((4096, 4096), 32), ((4096, 28672), 32),
             ((14336, 4096), 32), ((4096, 128256), 1)]
K3_MS = (1, 8, 128)  # regime A (decode)
K3_PREFILL_M = 6000  # regime B: the long prompt of phase 11 (LONG_PROMPTS[0])
K3_SLOTS_B = 136  # regime B at decode: phase 24's decode step over 136 slots
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
# ResNet-18's fc at the engine batch of 512; phase 23 adds ResNet-50's fc at 512
# and LeNet's first Linear at 1,024
K1_CASES = [
    ("path", 512, 512, 10, 0.05, 0.0, -128.0, 127.0, 200),
    ("resnet50_fc", 512, 2048, 10, 0.05, 0.0, -128.0, 127.0, 200),  # phase 23's ResNet-50 fc
    ("lenet_fc1", 1024, 400, 120, 0.05, 0.0, -128.0, 127.0, 200),  # LeNet's widest, at 1,024
    ("large", 8192, 4096, 4096, 0.05, 0.0, -128.0, 127.0, 10),
    ("ragged A4 zp", 333, 200, 19, 0.5, 3.0, -8.0, 7.0, 100),
]
# calls added after the phases' inputs were fixed (K1's two above, K3 at
# K3_SLOTS_B) draw from a generator of their own: the shared one then
# gives every later phase the inputs it had before they were added
OWN_DRAWS = ("resnet50_fc", "lenet_fc1", K3_SLOTS_B)


def own_generator(dev, what) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(1 + OWN_DRAWS.index(what))
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
# the exact f32 path on the card: the engine phases (9, 16, 17, 19) hold a
# fake-quant or fused model against the integer engine or the CPU, and
# phase 14's card-vs-CPU step holds the exact step, so each pins the
# training lowerings off, as the JAX package does for its own engine
# checks (benchmarks/acc_table.py:206-218); "auto" would run bf16 codes
EXACT = dict(act_codes="off", bn_stats="off")
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


def _k3_bound(m, k, n, group=GROUP):
    """K3's least time (ms) for one call and what sets it: x read, the packed
    weights and scales read, the output written once; 2MKN bf16 operations."""
    nbytes = m * k * 4 + k // 2 * n + k // group * n * 4 + m * n * 4
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
    reading takes: at a decode step's M (up to ``K3_SLOTS_B``) 30 calls over
    every copy, so each finds its weights cold in L2; at the prefill's M a
    few calls on one copy."""
    xb = x.to(torch.bfloat16)
    if m == K3_PREFILL_M:
        return [(x, *weights[0])], [(xb, w_bf16[0])], 3
    return [(x, p, g) for p, g in weights], [(xb, w) for w in w_bf16], 30


def check_k3(dev, gen, report):
    """K3 at the five W4 shapes of one Llama-3-8B forward: M = 1, 8 and 128
    (regime A, decode) and 136 (regime B, phase 24's decode step past 128
    slots) against the whole twin, weights cold in L2; M = 6,000
    (regime B, the long prompt's prefill) against the twin on a sample of
    rows (the first, the last and 62 drawn from ``gen``) in column chunks,
    since the whole twin would hold (K/g, M, N) f32. Each beside
    ``torch.matmul`` on the dequantized bf16 weight, by events; the device
    times come later, from :func:`k3_device_times`."""
    from micronet_tpu_torch.ops import int4_matmul as im

    cases = {}
    for (k, n), per_step in K3_SHAPES:
        weights, w_bf16 = _k3_weights(k, n, dev, gen)
        for m in K3_MS + (K3_SLOTS_B, K3_PREFILL_M):
            x = torch.randn((m, k), device=dev, generator=own_generator(dev, m)
                            if m in OWN_DRAWS else gen)
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
    """K3's device time (``torch.profiler``) at phase 3's shapes, M = 8, 136
    and 6,000, beside ``torch.matmul``'s on the dequantized bf16 weight, on
    fresh weights from ``gen``; adds a decode step's 129 calls at M = 8 and
    at 136 and a prefill's to the kernels-line ``row``. Taken after the serving phases, so
    that no profiler session runs before them (as in the smoke runs before
    this reading was added)."""
    from micronet_tpu_torch.ops import int4_matmul as im

    cases = {(c["m"], c["k"], c["n"]): c for c in report["k3_cases"]}
    for (k, n), _ in K3_SHAPES:
        weights, w_bf16 = _k3_weights(k, n, dev, gen)
        for m in (8, K3_SLOTS_B, K3_PREFILL_M):
            x = torch.randn((m, k), device=dev, generator=own_generator(dev, m)
                            if m in OWN_DRAWS else gen)
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
    wide = forward(K3_SLOTS_B, ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                                "library_device_ms"))
    row.update({f"m{K3_SLOTS_B}_{key}": v for key, v in wide.items()})
    report["k3_cases"] = list(cases.values())
    log(f"K3 forward at M=8: device {row['device_ms']:.3f} ms, torch.matmul "
        f"{row['library_device_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms; at M="
        f"{K3_PREFILL_M}: device {pre['device_ms']:.2f} ms, torch.matmul "
        f"{pre['library_device_ms']:.2f} ms, bound {pre['bound_ms']:.2f} ms "
        f"({row['prefill_bound_share']:.1%} of it); at M={K3_SLOTS_B} (regime B): device "
        f"{wide['device_ms']:.3f} ms, torch.matmul {wide['library_device_ms']:.3f} ms, bound "
        f"{wide['bound_ms']:.3f} ms")


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


def _when(later, fn):
    """Run ``fn`` now, or, where the caller passes its ``later`` list,
    after phase 12's device readings."""
    if later is None:
        fn()
    else:
        later.append(fn)


def serve(dev, seed, report, profile_dir=None, later=None, keep=None):
    """Slice 1's main path (phase 5). ``keep``, a dict, receives the model,
    the requests and each request's tokens (phase 24)."""
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
        _when(later, lambda: profile_decode(model, dev, reqs, report, profile_dir))
    if keep is not None:
        keep.update(model=model, reqs=reqs, outputs={rid: r.output for rid, r in done.items()})
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
        args = k1_args(m, k, n, s_x, zp, qmin, qmax, dev,
                       own_generator(dev, label) if label in OWN_DRAWS else gen)
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
        args = k1_args(m, k, n, s_x, zp, qmin, qmax, dev,
                       own_generator(dev, label) if label in OWN_DRAWS else gen)
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


# calls a reading of the conv epilogue, by events and by torch.profiler
EPILOGUE_ITERS = 20


@torch.no_grad()
def epilogue_device_times(engines, report):
    """The conv epilogue (``ops/requant_epilogue.py``) at every symmetric
    conv of phase 9's engines, on its own accumulator rows from one
    forward: ms by events and device ms (``torch.profiler``) of the
    wrapper and of its twin on the card (the plain chain of PyTorch
    operations), beside the bytes bound M x O x (4 + 1) (int8 codes out)
    or x (4 + 4) (f32 out) at 3.35 TB/s. Returns the kernels line's
    ``requant_epilogue`` row's fields: each net's sums and its layers."""
    from micronet_tpu_torch.ops.requant_epilogue import requant_epilogue, requant_epilogue_ref

    nets = {}
    for name, keep in engines.items():
        layers = []
        for lname, args in _epilogue_cases(keep["engine"], keep["x"]):
            rows = args[0]
            m, o = rows.shape
            bound = m * o * (rows.element_size() + (1 if args[-1] else 4)) / HBM_BYTES_PER_S
            layers.append(dict(
                layer=lname, m=m, o=o, ld=rows.stride(0), out="int8" if args[-1] else "f32",
                ms=time_ms(requant_epilogue, [args], EPILOGUE_ITERS),
                device_ms=device_ms(requant_epilogue, [args], EPILOGUE_ITERS),
                plain_ms=time_ms(requant_epilogue_ref, [args], EPILOGUE_ITERS),
                plain_device_ms=device_ms(requant_epilogue_ref, [args], EPILOGUE_ITERS),
                bound_ms=bound * 1e3))
            del rows, args
        net = {key: sum(r[key] for r in layers)
               for key in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms")}
        net.update(launches_phase9=report[name]["epilogue_launches"], layers=layers)
        nets[name] = net
        log(f"conv epilogue, {name}: {len(layers)} convs a forward, device "
            f"{net['device_ms']:.4f} ms (events {net['ms']:.4f}), twin device "
            f"{net['plain_device_ms']:.4f} ms, bound {net['bound_ms']:.4f} ms "
            f"({net['bound_ms'] / net['device_ms']:.1%} of it)")
        for r in layers:
            log(f"  {r['layer']:<24} M {r['m']:>8} O {r['o']:>5} ld {r['ld']:>5} -> "
                f"{r['out']:<4} device {r['device_ms']:.4f} ms, twin {r['plain_device_ms']:.4f}"
                f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['device_ms']:.1%})")
        torch.cuda.empty_cache()
    return nets


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
def engine_path(name, build, cfg, batch, dev, seed, report, profile_dir=None, later=None,
                exact=False, keep=None, fq_tol=FQ_TOL):
    """One IAO engine flow at full width on the card: random weights from a
    seeded generator, ``prepare``, calibration forwards in train mode,
    ``fuse_bn_iao``, ``freeze_int`` with an example input, then the engine
    at ``batch``. The kernel counts are zeroed just before the engine
    forwards and read just after. The same engine on the CPU (the
    wrappers' twins, f64 convs) must agree on a few images. With ``exact``
    (an asymmetric engine, no f32 first layer) the card must equal the CPU
    layer by layer (:func:`_layers_card_vs_cpu`) and each layer's
    accumulator the exact integer value within the rounding of the f32
    correction order (:func:`_layers_vs_exact`); the whole model's gap to
    its fake-quant model is reported, not held (see ``asym_resnet18``);
    otherwise it is held to ``fq_tol``. ``keep``, a dict, receives the
    engine and the fp32 model (phase 19)."""
    import copy

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.ops import patch_gather
    from micronet_tpu_torch.ops.dwconv import dwconv_int8
    from micronet_tpu_torch.ops.requant_epilogue import requant_epilogue

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
    for kern in kernels + (requant_epilogue, dwconv_int8, patch_gather.patch_matrix,
                           patch_gather.patch_shuffle):
        kern.launches = 0
    # -- the main path: engine forwards --------------------------------
    out = engine(x)
    engine_ms = _forward_ms(engine, x, ENGINE_ITERS)
    launches = {kern.__name__: kern.launches for kern in kernels}
    epilogues, dwconvs = requant_epilogue.launches, dwconv_int8.launches
    patches = patch_gather.patch_matrix.launches + patch_gather.patch_shuffle.launches
    # ------------------------------------------------------------------
    forwards = 1 + ENGINE_ITERS
    if tuple(out.shape) != (batch, 10) or not torch.isfinite(out).all():
        fail(f"{name}: engine output {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    fp32(x)
    fp32_ms = _forward_ms(fp32, x, ENGINE_ITERS)
    _when(later, lambda: _profile_engine(name, engine, x, report, profile_dir))
    fq = fused(x)
    fq_agree = (out.argmax(-1) == fq.argmax(-1)).float().mean().item()
    checks = {}
    if exact:
        fq_diff = (out[:CPU_BATCH] - fq[:CPU_BATCH]).abs().max().item()
        checks.update(_layers_vs_exact(name, engine, x[:CPU_BATCH]))
        t1 = time.perf_counter()
        checks.update(_layers_card_vs_cpu(name, engine, x[:CPU_BATCH]))
        cpu_s = time.perf_counter() - t1
        diff = checks["logits_max_abs"]
    else:
        fq_diff = _agree(f"{name}: engine vs its fake-quant model", out[:CPU_BATCH],
                         fq[:CPU_BATCH], fq_tol)
        cpu_engine = copy.deepcopy(engine).to("cpu")
        t1 = time.perf_counter()
        ref = cpu_engine(x[:CPU_BATCH].cpu())
        cpu_s = time.perf_counter() - t1
        diff = _agree(f"{name}: engine on the card vs on the CPU", out[:CPU_BATCH].cpu(), ref,
                      CARD_CPU_TOL)
    res = dict(batch=batch, setup_s=setup_s, chained_layers=len(chained), launches=launches,
               epilogue_launches=epilogues, dwconv_launches=dwconvs, patch_launches=patches,
               forwards=forwards,
               engine_ms=engine_ms, engine_img_s=batch / engine_ms * 1e3,
               fp32_ms=fp32_ms, fp32_img_s=batch / fp32_ms * 1e3,
               engine_vs_fake_quant_max_abs=fq_diff, engine_vs_fake_quant_argmax_agree=fq_agree,
               card_vs_cpu_max_abs=diff, cpu_rows=CPU_BATCH, cpu_engine_s=cpu_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, **checks)
    report[name] = res
    log(f"{name}: setup {setup_s:.1f} s, {len(chained)} chained layers; engine at batch "
        f"{batch}: {engine_ms:.2f} ms = {res['engine_img_s']:.0f} img/s, port fp32 eval "
        f"(TF32 off) {fp32_ms:.2f} ms = {res['fp32_img_s']:.0f} img/s; launches {launches}, "
        f"conv epilogue {epilogues}, depthwise {dwconvs}, patch gathers {patches}, over "
        f"{forwards} forwards")
    log(f"{name}: on {CPU_BATCH} images, engine vs its fake-quant model max|diff| "
        f"{fq_diff:.3e}, engine on the card vs on the CPU max|diff| {diff:.3e}; argmax "
        f"agreement with the fake-quant model over the batch {fq_agree:.4f}")
    if keep is not None:
        keep.update(engine=engine, fp32=fp32, x=x)
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


def resnet_engine(dev, seed, report, profile_dir=None, later=None, keep=None):
    from micronet_tpu_torch.models.resnet import resnet18
    from micronet_tpu_torch.quant.config import QuantConfig

    launches, forwards = engine_path("resnet18_w8a8", resnet18,
                                     QuantConfig(a_bits=8, w_bits=8, bn_fuse=True, **EXACT),
                                     RESNET_BATCH, dev, seed, report, profile_dir, later,
                                     keep=keep)
    want = {k.__name__: 0 for k in _all_kernels()}
    want["int8_matmul_dequant"] = forwards  # the fc, once per forward
    if launches != want:
        fail(f"resnet18_w8a8: launch counts {launches}, expected {want}")
    _check_epilogues("resnet18_w8a8", report, 20, keep)
    _check_patches("resnet18_w8a8", report, 20, keep)
    return launches


def _epilogue_cases(engine, x):
    """For each symmetric ``IntConv2d`` of ``engine`` in order, on its own
    input in one forward of ``x`` (kept by a hook): its name and the conv
    epilogue's arguments over its accumulator rows (the route's (M, O)
    view, as ``IntConv2d._epilogue`` passes them); one accumulator alive
    at a time."""
    from micronet_tpu_torch.infer import engine as E

    convs = [(n, m) for n, m in engine.named_modules()
             if isinstance(m, E.IntConv2d) and m.symmetric and m.w_symmetric]
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args: inputs.__setitem__(mod, args[0]))
             for _, m in convs]
    try:
        engine(x)
    finally:
        for h in hooks:
            h.remove()
    for lname, m in convs:
        x_in = inputs.pop(m)
        x_q = x_in if x_in.dtype == torch.int8 else E._act_codes(
            x_in, m.act_scale, m.act_zero_point, m.a_qmin, m.a_qmax, True)
        acc, w_scale = (m.dequant_conv(x_q), None) if m.f32_dequant else (m.int_acc(x_q),
                                                                            m.w_scale)
        rows = E._nhwc(acc).reshape(-1, acc.shape[1])
        yield lname, (rows, m.act_scale, w_scale, m.bias, m.out_scale, m.out_qmin, m.out_qmax,
                      m.chained)


@torch.no_grad()
def _check_epilogues(name, report, convs, keep):
    """Fail unless the conv epilogue launched once per symmetric conv per
    forward on phase 9's main path and the depthwise kernel never (no conv
    of these nets is depthwise: NIN-GC's grouped convs keep the
    block-diagonal GEMM), and unless at every symmetric conv the wrapper
    equals its twin on the card bit for bit (f32 as int32)."""
    from micronet_tpu_torch.ops.requant_epilogue import requant_epilogue, requant_epilogue_ref

    res = report[name]
    if res["epilogue_launches"] != convs * res["forwards"] or res["dwconv_launches"]:
        fail(f"{name}: conv epilogue launches {res['epilogue_launches']}, expected {convs} x "
             f"{res['forwards']} forwards; depthwise kernel {res['dwconv_launches']}, "
             f"expected 0")
    layers = []
    for lname, args in _epilogue_cases(keep["engine"], keep["x"]):
        got, want = requant_epilogue(*args), requant_epilogue_ref(*args)
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        rows = args[0]
        layers.append(dict(layer=lname, m=rows.shape[0], o=rows.shape[1], ld=rows.stride(0),
                           acc=str(rows.dtype)[6:], out="int8" if args[-1] else "f32",
                           bias=args[3] is not None, equal=bool(torch.equal(got, want))))
        del got, want, rows, args
    if len(layers) != convs or not all(r["equal"] for r in layers):
        fail(f"{name}: conv epilogue against its twin at each symmetric conv: "
             f"{[(r['layer'], r['equal']) for r in layers]}, expected {convs} layers, all equal")
    res["epilogue_layers"] = layers
    log(f"{name}: conv epilogue equal to its twin bit for bit at all {convs} symmetric convs")


def nin_engine(dev, seed, report, profile_dir=None, later=None, keep=None):
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.quant.config import QuantConfig

    # NIN-GC's classifier is a 1x1 conv: K1 is not on this path, the conv epilogue is
    engine_path("nin_gc_w4a4", Net, QuantConfig(a_bits=4, w_bits=4, bn_fuse=True, **EXACT),
                NIN_BATCH, dev, seed, report, profile_dir, later, keep=keep)
    _check_epilogues("nin_gc_w4a4", report, 9, keep)
    _check_patches("nin_gc_w4a4", report, 9, keep)


PATCH_ITERS = 20


@torch.no_grad()
def _patch_cases(engine, x):
    """Every patch-gather call of one forward of ``engine`` on ``x``, in
    order, on its own input (kept by wrapping the engine's
    ``patch_matrix`` and the models' ``patch_shuffle``): ``(name,
    args)``, ``name`` the wrapper's in ``ops/patch_gather.py``."""
    from micronet_tpu_torch.infer import engine as E
    from micronet_tpu_torch.nn import functional as F
    from micronet_tpu_torch.ops import patch_gather as PG

    calls = []

    def matrix(x, kernel, stride, padding, dilation, scale=None):
        calls.append(("patch_matrix", (x, tuple(kernel), tuple(stride), tuple(padding),
                                       tuple(dilation), scale)))
        return PG.patch_matrix(x, kernel, stride, padding, dilation, scale)

    def shuffle(x, groups):
        calls.append(("patch_shuffle", (x, groups)))
        return PG.patch_shuffle(x, groups)

    E.patch_matrix, F.patch_shuffle = matrix, shuffle
    try:
        engine(x)
    finally:
        E.patch_matrix, F.patch_shuffle = PG.patch_matrix, PG.patch_shuffle
    return calls


def _patch_layer(kind, args, out):
    """A patch-gather call's shape, output type and bytes bound: its input
    read once (the codes its patches touch: a strided 1 x 1 conv's quarter
    of them) and its output written once at 3.35 TB/s."""
    x = args[0]
    n, c, h, w = x.shape
    what = (f"{args[1][0]}x{args[1][1]} s{args[2][0]} p{args[3][0]} d{args[4][0]}"
            if kind == "patch_matrix" else f"g{args[1]}")
    nbytes = min(x.numel(), out.numel()) * x.element_size() + out.numel() * out.element_size()
    return dict(kind=kind, n=n, c=c, h=h, w=w, what=what, out=str(out.dtype)[6:],
                nhwc_input=x.permute(0, 2, 3, 1).is_contiguous(),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


@torch.no_grad()
def _check_patches(name, report, calls, keep):
    """Fail unless the patch gathers launched ``calls`` times a forward on
    the main path, and unless each call of one forward, on its own input,
    equals its twin on the card bit for bit (f32 as int32) and read
    NHWC-backed codes (the wrapper made no NHWC copy)."""
    from micronet_tpu_torch.ops import patch_gather as PG

    res = report[name]
    if res["patch_launches"] != calls * res["forwards"]:
        fail(f"{name}: patch gathers launched {res['patch_launches']} times, expected "
             f"{calls} x {res['forwards']} forwards")
    layers = []
    for kind, args in _patch_cases(keep["engine"], keep["x"]):
        got, want = getattr(PG, kind)(*args), getattr(PG, f"{kind}_ref")(*args)
        row = _patch_layer(kind, args, got)
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        row["equal"] = bool(got.shape == want.shape and torch.equal(got, want))
        layers.append(row)
        del got, want, args
    if (len(layers) != calls or not all(r["equal"] for r in layers)
            or not all(r["nhwc_input"] for r in layers)):
        fail(f"{name}: patch gathers against their twins: "
             f"{[(r['kind'], r['what'], r['equal'], r['nhwc_input']) for r in layers]}, "
             f"expected {calls} calls, all equal, all on NHWC-backed codes")
    res["patch_layers"] = layers
    log(f"{name}: patch gathers equal to their twins bit for bit at all {calls} calls of a "
        f"forward, every one on NHWC-backed codes")


@torch.no_grad()
def patch_device_times(nets, report):
    """The patch gathers (``ops/patch_gather.py``) at every call of one
    forward of phase 9's and 25's engines, on its own input: ms by events
    and device ms (``torch.profiler``) of the wrapper and of its twin on
    the card (PyTorch's pad and unfold copies, or the shuffle's reshape
    and transpose), beside the bytes bound. Returns the kernels line's
    ``patch_gather`` row's fields: each net's sums and its layers."""
    from micronet_tpu_torch.ops import patch_gather as PG

    out = {}
    for name, keep in nets.items():
        layers = report[name]["patch_layers"]
        for row, (kind, args) in zip(layers, _patch_cases(keep["engine"], keep["x"])):
            fn, twin = getattr(PG, kind), getattr(PG, f"{kind}_ref")
            row.update(ms=time_ms(fn, [args], PATCH_ITERS),
                       device_ms=device_ms(fn, [args], PATCH_ITERS),
                       plain_ms=time_ms(twin, [args], PATCH_ITERS),
                       plain_device_ms=device_ms(twin, [args], PATCH_ITERS))
            del args
        net = {key: sum(r[key] for r in layers)
               for key in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms")}
        net.update(launches_main_path=report[name]["patch_launches"], layers=layers)
        out[name] = net
        log(f"patch gathers, {name}: {len(layers)} calls a forward, device "
            f"{net['device_ms']:.4f} ms (events {net['ms']:.4f}), twin device "
            f"{net['plain_device_ms']:.4f} ms, bound {net['bound_ms']:.4f} ms "
            f"({net['bound_ms'] / net['device_ms']:.1%} of it)")
        for r in layers:
            log(f"  {r['kind']:<13} {r['what']:<14} N {r['n']:>5} C {r['c']:>5} H {r['h']:>3} "
                f"-> {r['out']:<7} device {r['device_ms']:.4f} ms, twin "
                f"{r['plain_device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_ms'] / r['device_ms']:.1%})")
        torch.cuda.empty_cache()
    return out


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
    """Run ``reqs`` (fresh copies, sampling settings kept) through
    ``loop``; returns the outputs by request id, the admissions deferred and
    the wall seconds."""
    import dataclasses

    for r in reqs:
        loop.submit(dataclasses.replace(r, prompt=list(r.prompt), output=[], done=False))
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


def _check_pages_back(loop, free):
    """Fail unless every page of the paged ``loop``'s pools is free again
    (``free`` usable pages) and no slot keeps a length or a table entry."""
    for c in loop.caches:
        if (int(c.free_top) != free or int(c.lengths.abs().sum())
                or int(c.page_table.abs().sum())):
            fail(f"paged loop: pages did not all return ({int(c.free_top)} of {free} free)")


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


def serve_long(dev, seed, card, report, profile_dir=None, later=None):
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
            _check_pages_back(loop, usable)
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
            _when(later, lambda mode=mode, kw=kw: profile_decode(
                model, dev, reqs, report, profile_dir, f"profile_long_{mode}", **kw))
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


# ---------------------------------------------------------------- phase 14


# slice 5: the CLI's training path. NIN-GC at its default widths and the
# CLI's default batch, on the synthetic set at its default 2,048 images
# (8 steps an epoch); (label, method flags)
TRAIN_METHODS = [("float", ["--method", "float"]), ("iao", ["--method", "iao", "--bn_fuse"]),
                 ("dorefa", ["--method", "dorefa"]),
                 ("wbwtab", ["--method", "wbwtab", "--W", "3", "--A", "2"]),
                 ("wbwtab_w2", ["--method", "wbwtab", "--W", "2", "--A", "2"])]
TRAIN_EPOCHS, TRAIN_BATCH, STEP_BATCH = 2, 256, 8
# the card's step against the CPU's, block by block from the CPU's inputs
# to each block (f32 convs summed in another order; TF32 off): the last
# block's loss within STEP_RTOL relative, outputs within STEP_RTOL x
# max(1, max|out|), gradients within STEP_RTOL x max|g|
STEP_RTOL = 1e-4
# a code, sign, STE or ReLU mask may round the other way on the card only
# this close to its edge (codes in grid units; signs and masks in |x|;
# ternary thresholds relative); a flip anywhere else fails the run
CODE_EDGE, SIGN_EDGE, CENTER_EDGE, TERNARY_EDGE = 1e-3, 1e-4, 1e-6, 1e-5


def _near_half(v):
    v = v.double()
    return (v - torch.floor(v) - 0.5).abs() < CODE_EDGE


def _quant_points(block):
    """Forward hooks recording, per rounding edge of ``block`` whose input
    the card computes otherwise, its input and output: IAO weight
    quantizers (BN-folded weights), wbwtab signs and ReLUs (their
    gradient mask)."""
    from micronet_tpu_torch.nn import modules as M
    from micronet_tpu_torch.nn import qat_iao, qat_wbwtab

    rec, handles = {}, []
    for name, m in block.named_modules():
        if (isinstance(m, qat_iao.FakeQuantizer) and m.is_weight) or isinstance(m, M.ReLU) or (
                isinstance(m, qat_wbwtab.ActivationQuantizer) and m.A == 2):
            def hook(mod, inp, out, name=name):
                rec[name] = (mod, inp[0].detach(), out.detach())
            handles.append(m.register_forward_hook(hook))
    return rec, handles


def _weight_flips(block_card, block_cpu):
    """Out channels (axis 0 of the block's conv weights) whose DoReFa or
    wbwtab weight codes came out otherwise on the card; fails on a flip
    that is not at an edge."""
    from micronet_tpu_torch.nn import qat_dorefa, qat_wbwtab
    from micronet_tpu_torch.quant import dorefa, wbwtab

    chans = set()
    for (name, mc), mh in zip(block_card.named_modules(), block_cpu.modules()):
        if isinstance(mh, (qat_dorefa.QuantConv2d, qat_dorefa.QuantLinear)):
            step = ((1 << mh.w_bits) - 1) / 2.0
            codes = [torch.round((dorefa.quantize_weight(m.weight.detach(), mh.w_bits).cpu()
                                  + 1) * step) for m in (mc, mh)]
            t = torch.tanh(mh.weight.detach().double())
            edge = _near_half((t / (2 * t.abs().max()) + 0.5) * (2 * step))
        elif isinstance(mh, qat_wbwtab.QuantConv2d) and mh.W in (2, 3):
            codes = [torch.sign(wbwtab.quantize_weight(m.weight.detach(), mh.W)[0].cpu())
                     for m in (mc, mh)]
            w = mh.weight.detach().double()
            if mh.W == 3:
                thr = 0.7 * w.abs().mean(dim=(1, 2, 3), keepdim=True)
                edge = (w.abs() - thr).abs() < TERNARY_EDGE * thr
            else:
                edge = (w - w.mean(dim=1, keepdim=True)).abs() < CENTER_EDGE
        else:
            continue
        flipped = codes[0] != codes[1]
        if bool((flipped & ~edge).any()):
            fail(f"train step: {name}'s weight codes differ on the card away from an edge")
        chans |= set(flipped.reshape(flipped.shape[0], -1).any(1).nonzero().flatten().tolist())
    return chans


def _point_flips(rec_card, rec_cpu):
    """Channels of the block's output touched by an IAO weight code, a
    sign, a sign's STE mask or a ReLU's mask that came out otherwise on the
    card; fails on a flip that is not at an edge."""
    from micronet_tpu_torch.nn import modules as M

    chans = set()
    for name, (m, x_h, out_h) in rec_cpu.items():
        _, x_c, out_c = rec_card[name]
        x_c, out_c = x_c.cpu(), out_c.cpu()
        if getattr(m, "is_weight", False):
            v_h = x_h / m.scale - m.zero_point
            flipped = torch.round(out_c / rec_card[name][0].scale.cpu()) != torch.round(
                out_h / m.scale)
            edge = _near_half(v_h)
            axis_ch = flipped.reshape(flipped.shape[0], -1).any(1)
        elif isinstance(m, M.ReLU):  # its gradient passes where x > 0
            flipped = (x_c > 0) != (x_h > 0)
            edge = x_h.abs() < SIGN_EDGE
            axis_ch = flipped.transpose(0, 1).reshape(flipped.shape[1], -1).any(1)
        else:  # a sign: the value and its STE mask |x| < 1
            flipped = (out_c != out_h) | ((x_c.abs() < 1) != (x_h.abs() < 1))
            edge = (x_h.abs() < SIGN_EDGE) | ((x_h.abs() - 1).abs() < SIGN_EDGE)
            axis_ch = flipped.transpose(0, 1).reshape(flipped.shape[1], -1).any(1)
        if bool((flipped & ~edge).any()):
            fail(f"train step: {name} rounds otherwise on the card away from an edge")
        chans |= set(axis_ch.nonzero().flatten().tolist())
    return chans


def _close_or_fail(what, got, ref, atol, keep=None):
    got, ref = got.detach().cpu(), ref.detach().cpu()
    if keep is not None:
        got, ref = got[keep], ref[keep]
    diff = (got - ref).abs().max().item() if got.numel() else 0.0
    if not diff <= atol:
        fail(f"train step: {what} max|diff| {diff:.3e} (tol {atol:.3e})")
    return diff


def step_card_vs_cpu(method_flags, batch, dev, seed, cfg_widths=None):
    """One training step of ``method_flags`` on NIN-GC (default widths
    unless ``cfg_widths``) on the card against the same step on the CPU,
    block by block: each card block gets the CPU's input to it and the
    CPU's gradient with respect to its output, and must give the CPU's
    output, input gradient, parameter gradients and state (BN running
    statistics, observers) after the step. Where a value the card computes
    otherwise rounds the other way at an edge (a BN-folded weight's code, a
    sign or its mask, a ReLU's mask), the channels it touches leave the
    comparison, and with them the block's input gradient. Returns the
    numbers of the comparison."""
    import copy

    import torch.nn.functional as TF

    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import data as data_lib

    method = method_flags[method_flags.index("--method") + 1]
    kw = dict(bn_fuse="--bn_fuse" in method_flags)
    if method == "wbwtab":
        kw = dict(W=int(method_flags[method_flags.index("--W") + 1]),
                  A=int(method_flags[method_flags.index("--A") + 1]))
    cpu = Net(cfg=cfg_widths, device="cpu", generator=torch.Generator().manual_seed(seed))
    if method != "float":
        cpu = prepare(cpu, QuantConfig(**kw, **EXACT), method=method, device="cpu")
    cpu = train_mode(cpu)
    card = copy.deepcopy(cpu).to(dev)
    ds = data_lib._synthetic(batch, 1)
    gen = torch.Generator().manual_seed(seed)
    x = data_lib.augment_batch(gen, torch.from_numpy(ds[0])).permute(0, 3, 1, 2)
    y = torch.from_numpy(ds[1].astype(np.int64))
    blocks_h, blocks_c = list(cpu.model.layers), list(card.model.layers)
    # the CPU's forward through a copy records every block's input
    xs = [x]
    with torch.no_grad():
        for b in copy.deepcopy(cpu).model.layers:
            xs.append(b(xs[-1]))
    logits = xs[-1].reshape(batch, -1).requires_grad_()
    loss_h = TF.cross_entropy(logits, y)
    loss_h.backward()
    g = logits.grad.reshape(xs[-1].shape)
    grads = [None] * len(blocks_h)
    for i in reversed(range(len(blocks_h))):  # the CPU's backward, block by block
        xi = xs[i].clone().requires_grad_()
        rec, handles = _quant_points(blocks_h[i])
        out = blocks_h[i](xi)
        for h in handles:
            h.remove()
        (out * g).sum().backward()
        grads[i] = (g, out.detach(), xi.grad, rec)
        g = xi.grad
    gmax = max(p.grad.abs().max().item() for p in cpu.parameters())
    n_chan = skipped_gx = 0
    worst = dict(out=0.0, gx=0.0, grad=0.0, state=0.0)
    for i, (bh, bc) in enumerate(zip(blocks_h, blocks_c)):
        g, out_h, gx_h, rec_h = grads[i]
        xi = xs[i].to(dev).requires_grad_()
        rec_c, handles = _quant_points(bc)
        out = bc(xi)
        for h in handles:
            h.remove()
        (out * g.to(dev)).sum().backward()
        if i == len(blocks_c) - 1:
            loss_c = TF.cross_entropy(out.detach().reshape(batch, -1), y.to(dev))
        chans = _point_flips(rec_c, rec_h) | _weight_flips(bc, bh)
        n_chan += len(chans)
        keep = torch.ones(out_h.shape[1], dtype=torch.bool)
        keep[list(chans)] = False
        what = f"{method} block {i} ({type(bh).__name__})"
        worst["out"] = max(worst["out"], _close_or_fail(
            what + " output", out.permute(1, 0, 2, 3), out_h.permute(1, 0, 2, 3),
            STEP_RTOL * max(1.0, out_h.abs().max().item()), keep))
        if chans:
            skipped_gx += 1
        else:
            worst["gx"] = max(worst["gx"], _close_or_fail(
                what + " input gradient", xi.grad, gx_h, STEP_RTOL * gx_h.abs().max().item()))
        for (name, pc), ph in zip(bc.named_parameters(), bh.parameters()):
            k = keep if ph.shape[0] == keep.shape[0] else None
            worst["grad"] = max(worst["grad"], _close_or_fail(
                f"{what} gradient of {name}", pc.grad, ph.grad, STEP_RTOL * gmax, k))
        for (name, tc), th in zip(bc.state_dict().items(), bh.state_dict().values()):
            if th.dtype == torch.bool:
                if not torch.equal(tc.cpu(), th):
                    fail(f"train step: {what} state {name} differs on the card")
                continue
            k = keep if th.dim() and th.shape[0] == keep.shape[0] else None
            worst["state"] = max(worst["state"], _close_or_fail(
                f"{what} state {name}", tc.float(), th.float(),
                STEP_RTOL * max(1.0, th.abs().max().item()), k))
    loss_c, loss_h = float(loss_c), float(loss_h.detach())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    if not rel <= STEP_RTOL:
        fail(f"train step: {method} loss on the card {loss_c:.6f} vs the CPU {loss_h:.6f}")
    return dict(loss_cpu=loss_h, loss_rel_diff=rel, blocks=len(blocks_h),
                channels_at_an_edge=n_chan, blocks_without_input_grad_check=skipped_gx,
                gmax=gmax, **{f"max_abs_{k}": v for k, v in worst.items()})


def _cli(argv, what):
    """``micronet_tpu_torch.cli.main(argv)``: its output echoed, the run
    failed unless it returns 0."""
    import contextlib
    import io

    from micronet_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    if rc != 0:
        fail(f"{what}: cli {' '.join(map(str, argv[:3]))} returned {rc}")
    return text, seconds


def checkpoint_diff(a: Path, b: Path) -> dict:
    """The arrays in which two checkpoints differ, ``{key: max|difference|}``
    (inf for a key in one only or of another shape); empty when equal."""
    out = {}
    with np.load(a) as za, np.load(b) as zb:
        for k in sorted(set(za.files) | set(zb.files)):
            if k not in za.files or k not in zb.files or za[k].shape != zb[k].shape:
                out[k] = math.inf
            elif not np.array_equal(za[k], zb[k], equal_nan=True):
                out[k] = float(np.abs(za[k].astype(np.float64) - zb[k].astype(np.float64)).max())
    return out


def _train_numbers(metrics: Path, batch: int):
    """Step times (the run's first step left out), losses and accuracy
    from a run's metrics file."""
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    epochs = [r for r in rows if r["event"] == "epoch"]
    evals = [r for r in rows if r["event"] == "eval"]
    ms = [t for r in epochs for t in r["step_ms"]][1:]
    losses = [v for r in epochs for v in r["step_loss"]]
    return dict(steps=len(losses), losses=losses, step_ms_median=float(np.median(ms)),
                step_ms_max=float(np.max(ms)), img_s=batch * len(ms) / sum(ms) * 1e3,
                first_loss=losses[0], last_loss=losses[-1],
                test_acc_last=evals[-1]["acc"], test_acc_best=evals[-1]["best_acc"],
                epoch_seconds=[r["seconds"] for r in epochs])


def train_nin_gc(dev, seed, out_dir: Path, card: str, report):
    """Slice 5's main path on NIN-GC: ``cli train`` at full width for each
    method (every kernel count zeroed before and still 0 after: training
    runs no hand-written kernel), then ``cli model-test`` on the IAO and the
    binary wbwtab checkpoints (EQUIVALENCE OK), then each method's ``cli
    train`` again with the same seed, whose checkpoint must equal the first
    array for array, then each method's step on the card against the CPU's
    at batch 8."""
    res = {}
    kernels = _all_kernels()

    def train(label, flags, ck, *more):
        return _cli(["train", "--device", str(dev), *flags, "--epochs", TRAIN_EPOCHS,
                     "--train_batch_size", TRAIN_BATCH, "--seed", seed, "--save", ck, *more],
                    f"train {label}")

    for label, flags in TRAIN_METHODS:
        ck, metrics = out_dir / f"nin_gc_{label}.npz", out_dir / f"nin_gc_{label}.jsonl"
        metrics.unlink(missing_ok=True)
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        # -- the main path: cli train -----------------------------------
        _, seconds = train(label, flags, ck, "--metrics", metrics)
        launches = {k.__name__: k.launches for k in kernels}
        # ----------------------------------------------------------------
        if any(launches.values()):
            fail(f"train {label}: launch counts {launches}, expected none")
        r = _train_numbers(metrics, TRAIN_BATCH)
        r.update(seconds=seconds, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if not (math.isfinite(r["first_loss"]) and math.isfinite(r["last_loss"])
                and r["last_loss"] < r["first_loss"]):
            fail(f"train {label}: loss {r['first_loss']:.4f} -> {r['last_loss']:.4f}")
        res[label] = r
    for label, r in res.items():
        r["img_s_vs_float"] = r["img_s"] / res["float"]["img_s"]
        log(json.dumps({"phase": 14, "model": "nin_gc", "method": label, "batch": TRAIN_BATCH,
                        "card": card, **{k: r[k] for k in (
                            "img_s", "img_s_vs_float", "step_ms_median", "step_ms_max",
                            "peak_gb", "first_loss", "last_loss", "test_acc_last", "steps")}}))
    text, _ = _cli(["model-test", "--device", str(dev), "--bn_fuse", "--model",
                    out_dir / "nin_gc_iao.npz"], "model-test iao")
    if "EQUIVALENCE OK" not in text:
        fail("model-test on the IAO NIN-GC checkpoint did not print EQUIVALENCE OK")
    res["model_test"] = [line for line in text.splitlines() if "acc" in line or "FPS" in line]
    text, _ = _cli(["model-test", "--device", str(dev), "--method", "wbwtab", "--W", 2, "--A", 2,
                    "--model", out_dir / "nin_gc_wbwtab_w2.npz"], "model-test wbwtab_w2")
    if "EQUIVALENCE OK" not in text:
        fail("model-test on the binary wbwtab NIN-GC checkpoint did not print EQUIVALENCE OK")
    res["model_test_wbwtab_w2"] = [line for line in text.splitlines()
                                   if "acc" in line or "FPS" in line]
    for label, flags in TRAIN_METHODS:
        again = out_dir / f"nin_gc_{label}_again.npz"
        train(f"{label} again", flags, again)
        diff = checkpoint_diff(out_dir / f"nin_gc_{label}.npz", again)
        if diff:
            fail(f"train {label}: a second run with the same seed differs in {len(diff)} "
                 f"arrays, e.g. {dict(list(diff.items())[:4])}")
        with np.load(again) as z:
            res[label]["repeat_equal_arrays"] = len(z.files)
    log(f"train: a second run of each method with the same seed gives the same checkpoint, "
        f"{[res[label]['repeat_equal_arrays'] for label, _ in TRAIN_METHODS]} arrays each")
    for label, flags in TRAIN_METHODS:
        cmp = step_card_vs_cpu(flags, STEP_BATCH, dev, seed)
        res[label]["card_vs_cpu_step"] = cmp
        log(f"train step {label} (NIN-GC, batch {STEP_BATCH}), card vs CPU block by block: "
            f"loss rel diff {cmp['loss_rel_diff']:.2e}; max|diff| out "
            f"{cmp['max_abs_out']:.2e}, input grads {cmp['max_abs_gx']:.2e}, grads "
            f"{cmp['max_abs_grad']:.2e} (max|g| {cmp['gmax']:.2e}); "
            f"{cmp['channels_at_an_edge']} channels at an edge left out")
    report["train_nin_gc"] = res
    return res


# ---------------------------------------------------------------- phase 15


RESNET_PTQ_EPOCHS, NIN_PRUNE_EPOCHS = 1, 1


def ptq_resnet18(dev, seed, out_dir: Path, card: str, report):
    """``cli train --model_type 2 --method iao --ptq --ptq_observer kl
    --calib_cache`` on full-width ResNet-18 (KL-entropy PTQ), then ``cli
    freeze-int``; the engine rebuilt from the checkpoint, as freeze-int
    builds it, must hold the state freeze-int saved, launch K1 once per
    forward at batch 512 and agree with the same engine on the CPU."""
    import copy

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models.resnet import resnet18
    from micronet_tpu_torch.nn import eval_mode, prepare
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import load_state
    from micronet_tpu_torch.train.checkpoint import state_to_arrays

    ck, cache = out_dir / "resnet18_ptq.npz", out_dir / "resnet18_calib.json"
    eng_ck, metrics = out_dir / "resnet18_engine.npz", out_dir / "resnet18_ptq.jsonl"
    for p in (cache, metrics):
        p.unlink(missing_ok=True)
    model, ptq = ["--model_type", 2], ["--ptq", "--ptq_observer", "kl"]
    text, calib_s = _cli(["train", "--device", str(dev), *model, "--method", "iao", *ptq,
                          "--calib_cache", cache,
                          "--epochs", RESNET_PTQ_EPOCHS, "--ptq_control", "--seed", seed,
                          "--save", ck, "--metrics", metrics], "ptq resnet18")
    n_thr = len(json.loads(cache.read_text()))
    if f"resolved {n_thr} thresholds" not in text or n_thr < 20:
        fail(f"ptq resnet18: {n_thr} thresholds in the calibration table")
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    _, freeze_s = _cli(["freeze-int", "--device", str(dev), *model, *ptq, "--model", ck,
                        "--save", eng_ck], "freeze-int resnet18")
    # the engine as freeze-int builds it, to run it here
    cfg = QuantConfig(ptq=True, ptq_observer="kl")
    q = prepare(resnet18(device=dev, generator=torch.Generator(device=dev).manual_seed(0)),
                cfg, inplace=True, device=dev)
    load_state(ck, q)
    fused = eval_mode(fuse_bn_iao(q, cfg, device=dev))
    engine = eval_mode(freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3), device=dev),
                                  device=dev))
    saved = dict(np.load(eng_ck))
    for k, v in state_to_arrays(engine).items():
        if not np.array_equal(saved[f"model/{k}"], v):
            fail(f"freeze-int resnet18: the saved engine's {k} differs from the rebuilt one")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((RESNET_BATCH, 32, 32, 3), device=dev, generator=gen)
    kernels = _all_kernels()
    with torch.no_grad():
        for kern in kernels:
            kern.launches = 0
        # -- the main path: engine forwards ----------------------------
        out = engine(x)
        engine_ms = _forward_ms(engine, x, ENGINE_ITERS)
        launches = {k.__name__: k.launches for k in kernels}
        # --------------------------------------------------------------
        ref = copy.deepcopy(engine).to("cpu")(x[:CPU_BATCH].cpu())
    forwards = 1 + ENGINE_ITERS
    want = {k.__name__: 0 for k in kernels}
    want["int8_matmul_dequant"] = forwards
    if launches != want:
        fail(f"ptq resnet18 engine: launch counts {launches}, expected {want}")
    if tuple(out.shape) != (RESNET_BATCH, 10) or not torch.isfinite(out).all():
        fail(f"ptq resnet18 engine: output {tuple(out.shape)}")
    diff = _agree("ptq resnet18: engine on the card vs on the CPU", out[:CPU_BATCH].cpu(), ref,
                  CARD_CPU_TOL)
    img_s = RESNET_BATCH / engine_ms * 1e3
    res = dict(calibration_train_s=calib_s,
               calib_epoch_s=[r for r in rows if r["event"] == "epoch"][0]["seconds"],
               thresholds=n_thr, freeze_int_s=freeze_s, engine_ms=engine_ms,
               engine_img_s=img_s, phase9_engine_img_s=report["resnet18_w8a8"]["engine_img_s"],
               launches=launches, forwards=forwards, card_vs_cpu_max_abs=diff,
               test_acc=[r for r in rows if r["event"] == "eval"][-1]["acc"])
    report["ptq_resnet18"] = res
    log(json.dumps({"phase": 15, "model": "resnet18", "ptq": "kl", "card": card,
                    "calibration_s": calib_s, "calib_epoch_s": res["calib_epoch_s"],
                    "thresholds": n_thr, "engine_batch": RESNET_BATCH,
                    "engine_img_s": img_s, "phase9_engine_img_s": res["phase9_engine_img_s"],
                    "k1_launches": launches["int8_matmul_dequant"], "forwards": forwards,
                    "card_vs_cpu_max_abs": diff}))
    return launches["int8_matmul_dequant"]


def prune_nin(dev, seed, out_dir: Path, card: str, report):
    """NIN at its default widths: ``train --method float -sr``, ``prune
    --percent 0.5 --normal_regular 1``, ``train --method iao
    --prune_quant``; the pruned widths come back through the header. The
    first two run twice with the same seed: the same checkpoints and the
    same widths."""
    sr, pruned, pq = (out_dir / f"nin_{n}.npz" for n in ("sr", "pruned", "prune_quant"))
    metrics = out_dir / "nin_prune_quant.jsonl"
    metrics.unlink(missing_ok=True)

    def sr_prune(sr, pruned, tag=""):
        _, sr_s = _cli(["train", "--device", str(dev), "--method", "float", "-sr", "--s", "1e-4",
                        "--model_type", 0, "--epochs", NIN_PRUNE_EPOCHS, "--seed", seed,
                        "--train_batch_size", TRAIN_BATCH, "--save", sr], "train -sr nin" + tag)
        text, _ = _cli(["prune", "--device", str(dev), "--model_type", 0, "--model", sr,
                        "--save", pruned, "--percent", 0.5, "--normal_regular", 1],
                       "prune nin" + tag)
        return json.loads(text.split("cfg: ")[1].splitlines()[0]), sr_s

    cfg, sr_s = sr_prune(sr, pruned)
    sr2, pruned2 = out_dir / "nin_sr_again.npz", out_dir / "nin_pruned_again.npz"
    cfg2, _ = sr_prune(sr2, pruned2, " again")
    diff = {**checkpoint_diff(sr, sr2), **{f"pruned {k}": v
                                           for k, v in checkpoint_diff(pruned, pruned2).items()}}
    if cfg2 != cfg or diff:
        fail(f"prune nin: the same seed again pruned to {cfg2} (first {cfg}); checkpoints "
             f"differ in {len(diff)} arrays, e.g. {dict(list(diff.items())[:4])}")
    log(f"prune nin: the same seed again gives the same -sr and pruned checkpoints, cfg {cfg}")
    with np.load(pruned) as z:
        if json.loads(bytes(z["__header__"]).decode())["extra"].get("cfg") != cfg:
            fail("prune nin: the pruned checkpoint's header does not hold its cfg")
    if sum(cfg) >= sum([192, 160, 96, 192, 192, 192, 192, 192]):
        fail(f"prune nin: cfg {cfg} is not narrower than the default")
    _, pq_s = _cli(["train", "--device", str(dev), "--method", "iao", "--model_type", 0,
                    "--prune_quant", pruned, "--epochs", NIN_PRUNE_EPOCHS, "--seed", seed,
                    "--train_batch_size", TRAIN_BATCH, "--save", pq, "--metrics", metrics],
                   "train --prune_quant nin")
    r = _train_numbers(metrics, TRAIN_BATCH)
    if not all(math.isfinite(r[k]) for k in ("first_loss", "last_loss")):
        fail("train --prune_quant nin: the loss is not finite")
    res = dict(cfg=cfg, sr_seconds=sr_s, prune_quant_seconds=pq_s, **r)
    report["prune_nin"] = res
    log(json.dumps({"phase": 15, "model": "nin", "pipeline": "-sr -> prune -> --prune_quant",
                    "card": card, "cfg": cfg, "img_s": r["img_s"],
                    "first_loss": r["first_loss"], "last_loss": r["last_loss"],
                    "test_acc_last": r["test_acc_last"]}))


# ---------------------------------------------------------------- phases 16, 17


# slice 6: the ACC_TABLE recipe iao_w4a4_asym_fl8 (benchmarks/acc_table.py:611-615,
# and on ResNet-18 :654-660): asymmetric W4A4, first and last layers at 8 bits
ASYM_FLAGS = ["--q_type", 1, "--a_bits", 4, "--w_bits", 4, "--first_layer_a_bits", 8,
              "--first_layer_w_bits", 8, "--last_layer_a_bits", 8, "--last_layer_w_bits", 8]
ASYM_CFG = dict(q_type=1, a_bits=4, w_bits=4, first_layer_a_bits=8, first_layer_w_bits=8,
                last_layer_a_bits=8, last_layer_w_bits=8)
ASYM_TRAIN_EPOCHS = 1  # 8 steps at batch 256 on the synthetic set
# the engine against its fake-quant model: the tests' bound
# (tests/_torch_engine_flow.py QUANT_ATOL), relative to max(1, max|ref|)
QUANT_ATOL = 2e-2
# an f32 average (pools of up to 64 values; the card sums in f32, the CPU
# in f64) or a sigmoid, card against CPU, relative to max(1, max|ref|)
FLOAT_LAYER_RTOL = 1e-5
# phase 17: the engine matrix's UpNet and the dataflow tests' concat net
# (tests/test_engine_matrix.py:30-40, tests/test_engine_dataflow.py:24-33)
UPCAT_BATCH, UPCAT_SIZE = 256, 32
CONVT_CASES = [(16, 8, 4, 2, 1, 0, 1, 1), (8, 6, 3, 2, 1, 1, 1, 1), (8, 12, 3, 2, 0, 0, 1, 4),
               (6, 4, 3, 1, 2, 0, 2, 1), (6, 6, 3, 2, 3, 1, 1, 2)]


def _engine_layer_types():
    from micronet_tpu_torch.infer import engine as te
    from micronet_tpu_torch.nn import qat_iao as qi

    exact = (te.IntConv2d, te.IntConvTranspose2d, te.IntLinear, te.IntMaxPool2d, te.IntAdd,
             te.IntConcat, qi.QuantMaxPool2d, qi.QuantAdd, qi.QuantConcat, qi.QuantLeakyReLU)
    averaged = (te.IntAvgPool2d, qi.QuantAvgPool2d, qi.QuantAdaptiveAvgPool2d, qi.QuantSigmoid)
    return exact, averaged


def _recorded(model, types, x):
    """``model(x)`` and ``{name: (args, output)}`` of its modules of
    ``types`` (each called once)."""
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen.setdefault(name, (args, out))
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in model.named_modules()
             if isinstance(m, types)]
    try:
        out = model(x)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


@torch.no_grad()
def _layers_card_vs_cpu(name, engine, x):
    """The engine on the card against a copy on the CPU, each layer fed the
    card's input to it: every integer layer and every fake-quant layer
    left between them equal bit for bit, the f32 averages and sigmoids
    within FLOAT_LAYER_RTOL; then the whole output, CPU from the input on,
    within FLOAT_LAYER_RTOL (bit for bit where no average sits at the
    end)."""
    import copy

    exact, averaged = _engine_layer_types()
    out, seen = _recorded(engine, exact + averaged, x)
    cpu = copy.deepcopy(engine).to("cpu")
    n_exact = n_avg = 0
    worst_avg = 0.0
    for n, (args, o) in seen.items():
        m = cpu.get_submodule(n)
        got = m(*[a.cpu() for a in args])
        if got.dtype != o.dtype:
            fail(f"{name}: layer {n} gives {o.dtype} on the card, {got.dtype} on the CPU")
        err = (o.cpu().double() - got.double()).abs().max().item()
        if isinstance(m, exact):
            n_exact += 1
            if err != 0:
                fail(f"{name}: layer {n} on the card differs from the CPU from the same input "
                     f"(max|diff| {err:.3e})")
        else:
            n_avg += 1
            worst_avg = max(worst_avg, err)
            if err > FLOAT_LAYER_RTOL * max(1.0, got.abs().max().item()):
                fail(f"{name}: layer {n} (an f32 average) card vs CPU max|diff| {err:.3e}")
    ref = cpu(x.cpu())
    logits_err = (out.cpu() - ref).abs().max().item()
    if logits_err > FLOAT_LAYER_RTOL * max(1.0, ref.abs().max().item()):
        fail(f"{name}: output on the card vs the CPU max|diff| {logits_err:.3e}")
    return dict(layers_equal=n_exact, layers_averaged=n_avg, averaged_max_abs=worst_avg,
                logits_max_abs=logits_err)


@torch.no_grad()
def _layers_vs_exact(name, engine, x):
    """Each asymmetric conv and transposed conv of the engine, on the card's
    input codes to it: its f32 accumulator with the zero-point terms
    within the rounding bound of the JAX package's f32 order
    (``engine.exact_zero_point_acc``) of the exact integer value. Returns
    how many layers rounded at all and the largest ratio of an error to
    its bound."""
    from micronet_tpu_torch.infer import engine as te

    layers = (te.IntConv2d, te.IntConvTranspose2d)
    _, seen = _recorded(engine, layers, x)
    rounded, worst, n = 0, 0.0, 0
    for name_, (args, _) in seen.items():
        layer = engine.get_submodule(name_)
        if layer.symmetric and layer.w_symmetric:
            continue
        x_q = te._act_codes(args[0], layer.act_scale, layer.act_zero_point, layer.a_qmin,
                            layer.a_qmax, layer.symmetric)
        got = layer._zero_point_acc(x_q).double().cpu()
        exact, bound = te.exact_zero_point_acc(layer, x_q)
        err = (got - exact).abs()
        n += 1
        rounded += bool(err.max() > 0)
        worst = max(worst, (err / bound.clamp_min(1e-30)).max().item())
        if not bool((err <= bound).all()):
            fail(f"{name}: layer {name_}'s accumulator is past the f32 rounding bound of the "
                 f"exact value (max|err| {err.max().item():.3e})")
    return dict(asym_layers_vs_exact=n, layers_rounded=rounded, worst_err_over_bound=worst)


def _close(what, got, ref, rtol):
    err = (got - ref).abs().max().item()
    if err > rtol * max(1.0, ref.abs().max().item()):
        fail(f"{what}: max|diff| {err:.3e}")
    return err


def _profile_engine(name, engine, x, report, profile_dir):
    if profile_dir is not None:
        report[f"{name}_profile"] = trace(lambda: engine(x), 3, f"{name} engine forwards",
                                          profile_dir / f"chip_smoke_{name}_profile.txt")


def asym_nin_gc(dev, seed, out_dir: Path, card: str, report, profile_dir=None):
    """Slice 6's main path on NIN-GC: ``cli train`` with the asymmetric
    W4A4 first/last-8 recipe at full width (8 steps at batch 256), ``cli
    freeze-int`` with the same flags, then the engine rebuilt from the
    checkpoint as freeze-int builds it (it must hold the state freeze-int
    saved, key for key) at batch 1024. No hand-written kernel on this
    path: every count zeroed before the CLI and still 0 after the
    forwards."""
    import copy

    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.nn import eval_mode, prepare
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import load_state
    from micronet_tpu_torch.train.checkpoint import state_to_arrays

    name = "nin_gc_asym_w4a4_fl8"
    ck, eng_ck, metrics = (out_dir / f"{name}{s}" for s in (".npz", "_engine.npz", ".jsonl"))
    metrics.unlink(missing_ok=True)
    model = ["--model_type", 1, "--bn_fuse"]
    kernels = _all_kernels()
    for kern in kernels:
        kern.launches = 0
    # -- the main path: cli train, cli freeze-int, the engine ------------
    # (the Trainer's steps run cuDNN's deterministic algorithms, so the
    # engine checked below is the same trained net in every run)
    _, train_s = _cli(["train", "--device", str(dev), "--method", "iao", *model, *ASYM_FLAGS,
                       "--epochs", ASYM_TRAIN_EPOCHS, "--train_batch_size", TRAIN_BATCH,
                       "--seed", seed, "--save", ck, "--metrics", metrics], f"train {name}")
    _, freeze_s = _cli(["freeze-int", "--device", str(dev), *model, *ASYM_FLAGS, "--model", ck,
                        "--save", eng_ck], f"freeze-int {name}")
    cfg = QuantConfig(bn_fuse=True, **ASYM_CFG, **EXACT)
    q = prepare(Net(device=dev, generator=torch.Generator(device=dev).manual_seed(0)), cfg,
                inplace=True, device=dev)
    load_state(ck, q)
    fused = eval_mode(fuse_bn_iao(q, cfg, device=dev))
    engine = eval_mode(freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3), device=dev),
                                  device=dev))
    x = torch.randn((NIN_BATCH, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        out = engine(x)
        engine_ms = _forward_ms(engine, x, ENGINE_ITERS)
    launches = {k.__name__: k.launches for k in kernels}
    # ------------------------------------------------------------------
    if any(launches.values()):
        fail(f"{name}: launch counts {launches}, expected none (no kernel on this path)")
    saved = dict(np.load(eng_ck))
    rebuilt = state_to_arrays(engine)
    if {k for k in saved if k.startswith("model/")} != {f"model/{k}" for k in rebuilt}:
        fail(f"{name}: the saved engine's keys differ from the rebuilt one's")
    for k, v in rebuilt.items():
        if not np.array_equal(saved[f"model/{k}"], v):
            fail(f"{name}: the saved engine's {k} differs from the rebuilt one")
    zp_keys = sum(k.endswith(("/act_zero_point/.value", "/w_zp/.value")) for k in saved)
    convs = [m for m in engine.modules() if type(m).__name__ == "IntConv2d"]
    if len(convs) != 9 or any(m.symmetric or m.w_symmetric or m.chained for m in convs):
        fail(f"{name}: expected 9 asymmetric unchained IntConv2d")
    if tuple(out.shape) != (NIN_BATCH, 10) or not torch.isfinite(out).all():
        fail(f"{name}: engine output {tuple(out.shape)}")
    with torch.no_grad():
        fq = fused(x)
        fq_diff = _agree(f"{name}: engine vs its fake-quant model", out[:CPU_BATCH],
                         fq[:CPU_BATCH], QUANT_ATOL)
        fq_tol = QUANT_ATOL * max(1.0, fq[:CPU_BATCH].abs().max().item())
        checks = _layers_vs_exact(name, engine, x[:CPU_BATCH])
        checks.update(_layers_card_vs_cpu(name, engine, x[:CPU_BATCH]))
        _profile_engine(name, engine, x, report, profile_dir)
    r = _train_numbers(metrics, TRAIN_BATCH)
    sym = report["nin_gc_w4a4"]
    img_s = NIN_BATCH / engine_ms * 1e3
    res = dict(card=card, train_s=train_s, freeze_int_s=freeze_s, train_img_s=r["img_s"],
               first_loss=r["first_loss"], last_loss=r["last_loss"], batch=NIN_BATCH,
               engine_ms=engine_ms, engine_img_s=img_s,
               phase9_sym_engine_img_s=sym["engine_img_s"], fp32_img_s=sym["fp32_img_s"],
               vs_sym_engine=img_s / sym["engine_img_s"], vs_fp32=img_s / sym["fp32_img_s"],
               launches=launches, zero_point_keys=zp_keys, engine_vs_fake_quant_max_abs=fq_diff,
               engine_vs_fake_quant_tol=fq_tol,
               top1_agree_with_fake_quant=(out.argmax(-1) == fq.argmax(-1)).float().mean().item(),
               **checks)
    report[name] = res
    log(json.dumps({"phase": 16, "model": "nin_gc", **{k: res[k] for k in (
        "card", "engine_img_s", "phase9_sym_engine_img_s", "fp32_img_s", "vs_sym_engine",
        "vs_fp32", "engine_vs_fake_quant_max_abs", "engine_vs_fake_quant_tol",
        "top1_agree_with_fake_quant", "layers_rounded", "layers_equal", "logits_max_abs",
        "train_img_s", "first_loss", "last_loss")}}))


def asym_resnet18(dev, seed, card, report, profile_dir=None):
    """The same recipe on ResNet-18 at full width through phase 9's engine
    path at batch 512 (random weights, 4 calibration forwards). Its fc is
    an asymmetric ``IntLinear`` on ``torch._int_mm``: K1 launches 0
    times."""
    from micronet_tpu_torch.models.resnet import resnet18
    from micronet_tpu_torch.quant.config import QuantConfig

    name = "resnet18_asym_w4a4_fl8"
    launches, _ = engine_path(name, resnet18, QuantConfig(bn_fuse=True, **ASYM_CFG, **EXACT),
                              RESNET_BATCH, dev, seed, report, profile_dir, exact=True)
    if any(launches.values()):
        fail(f"{name}: launch counts {launches}, expected none (the asymmetric fc runs "
             f"torch._int_mm)")
    res = report[name]
    sym = report["resnet18_w8a8"]
    res.update(card=card, phase9_sym_engine_img_s=sym["engine_img_s"],
               vs_sym_engine=res["engine_img_s"] / sym["engine_img_s"],
               vs_fp32=res["engine_img_s"] / res["fp32_img_s"])
    log(json.dumps({"phase": 16, "model": "resnet18", **{k: res[k] for k in (
        "card", "engine_img_s", "phase9_sym_engine_img_s", "fp32_img_s", "vs_sym_engine",
        "vs_fp32", "engine_vs_fake_quant_max_abs", "engine_vs_fake_quant_argmax_agree",
        "layers_rounded", "worst_err_over_bound", "layers_equal", "logits_max_abs")}}))


def _upcat_nets(dev, gen):
    from micronet_tpu_torch.nn import modules as M

    class UpNet(torch.nn.Module):
        """conv -> stride-2 transposed conv (k 4, p 1) -> 1x1 conv."""

        def __init__(self):
            super().__init__()
            self.c1 = M.Conv2d(6, 16, 3, padding=1, device=dev, generator=gen)
            self.up = M.ConvTranspose2d(16, 8, 4, stride=2, padding=1, device=dev,
                                        generator=gen)
            self.c2 = M.Conv2d(8, 4, 1, device=dev, generator=gen)

        def forward(self, x):
            return self.c2(self.up(self.c1(x.permute(0, 3, 1, 2)))).permute(0, 2, 3, 1)

    class CatNet(torch.nn.Module):
        """two 1x1 convs into a channel concat, then a 1x1 conv."""

        def __init__(self):
            super().__init__()
            self.c1 = M.Conv2d(8, 16, 1, device=dev, generator=gen)
            self.c2 = M.Conv2d(8, 16, 1, device=dev, generator=gen)
            self.cat = M.Concat(-1)
            self.c3 = M.Conv2d(32, 8, 1, device=dev, generator=gen)

        def forward(self, x):
            x = x.permute(0, 3, 1, 2)
            return self.c3(self.cat(self.c1(x), self.c2(x))).permute(0, 2, 3, 1)

    return {"upnet": (UpNet, 6), "catnet": (CatNet, 8)}


def check_convt_routes(dev, gen, report):
    """The card's integer transposed conv (zero-inserted, padded or
    cropped input through im2col + ``torch._int_mm``) and its window sums
    against f64 ``conv_transpose2d``s of the same codes, bit for bit:
    UpNet's upsampler, output_padding 1, groups 4, dilation 2 and padding
    past d (k - 1), at batch 64 of 16 x 16."""
    import torch.nn.functional as TF

    from micronet_tpu_torch.infer.engine import IntConvTranspose2d

    for cin, co, k, s, p, op, d, g in CONVT_CASES:
        w = torch.randint(-128, 128, (cin, co // g, k, k), dtype=torch.int8, device=dev,
                          generator=gen)
        x = torch.randint(-128, 128, (64, cin, 16, 16), dtype=torch.int8, device=dev,
                          generator=gen)
        layer = IntConvTranspose2d(w, 1.0, 1.0, 0.0, None, (s, s), (p, p), (op, op), (d, d), g,
                                   -128.0, 127.0)
        acc, sums = layer.int_acc(x, group_sums=True)
        xc, wc = x.cpu().double(), w.cpu().double()
        ref = TF.conv_transpose2d(xc, wc, None, s, p, op, g, d)
        ref_sums = TF.conv_transpose2d(xc, torch.ones((cin, 1, k, k), dtype=torch.float64),
                                       None, s, p, op, g, d)
        if not (acc.dtype == torch.int32 and torch.equal(acc.cpu().double(), ref)
                and torch.equal(sums.cpu().double(), ref_sums)):
            fail(f"transposed conv route {cin}->{co} k{k} s{s} p{p} op{op} d{d} g{g}: "
                 f"max|err| {(acc.cpu().double() - ref).abs().max().item():.3e}")
    report["convt_routes"] = len(CONVT_CASES)
    log(f"transposed-conv routes: {len(CONVT_CASES)} shapes at batch 64, accumulators and "
        f"window sums equal the f64 conv_transpose2d bit for bit")


@torch.no_grad()
def upcat_engines(dev, seed, report, profile_dir=None):
    """Phase 17: UpNet and the concat net at 32 x 32, q_type 0 and 1:
    ``prepare``, 4 calibration forwards at batch 64, ``fuse_bn_iao`` (the
    weights pre-quantized), ``freeze_int`` with an example input, the
    engine at batch 256 (no hand-written kernel but the symmetric convs'
    epilogue: every other count zeroed just before and still 0 just
    after); the card equal to the CPU layer by
    layer, each asymmetric accumulator within its f32 rounding of the
    exact value, the output on 8 images within QUANT_ATOL of the
    fake-quant model (over the batch: reported); the
    symmetric concat net chains c1 and c2 into the concat and the concat
    into c3."""
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.infer.engine import IntConcat, IntConvTranspose2d
    from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
    from micronet_tpu_torch.nn.qat_iao import QuantConcat
    from micronet_tpu_torch.quant.config import QuantConfig

    gen = torch.Generator(device=dev).manual_seed(seed)
    check_convt_routes(dev, gen, report)
    kernels = _all_kernels()
    for net, (cls, cin) in _upcat_nets(dev, gen).items():
        for q_type in (0, 1):
            name = f"{net}_q{q_type}"
            cfg = QuantConfig(a_bits=8, w_bits=8, q_type=q_type, **EXACT)
            q = train_mode(prepare(cls(), cfg, device=dev))
            for _ in range(CALIB_STEPS):
                q(torch.randn((CALIB_BATCH, UPCAT_SIZE, UPCAT_SIZE, cin), device=dev,
                              generator=gen))
            fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device=dev))
            x = torch.randn((UPCAT_BATCH, UPCAT_SIZE, UPCAT_SIZE, cin), device=dev,
                            generator=gen)
            engine = eval_mode(freeze_int(fused, example_input=x[:1], device=dev))
            for kern in kernels:
                kern.launches = 0
            # -- the main path: engine forwards ------------------------
            out = engine(x)
            engine_ms = _forward_ms(engine, x, ENGINE_ITERS)
            launches = {k.__name__: k.launches for k in kernels}
            # ----------------------------------------------------------
            if any(launches.values()):
                fail(f"{name}: launch counts {launches}, expected none")
            # an asymmetric concat stays fake-quant, as in the JAX package
            want = IntConvTranspose2d if net == "upnet" else (
                IntConcat if q_type == 0 else QuantConcat)
            if not any(isinstance(m, want) for m in engine.modules()):
                fail(f"{name}: no {want.__name__} in the engine")
            chained = sorted(n for n, m in engine.named_modules()
                             if getattr(m, "chained", False))
            if chained != (["c1", "c2", "cat"] if (net, q_type) == ("catnet", 0) else []):
                fail(f"{name}: chained {chained}")
            fq = fused(x)
            fq_diff = _close(f"{name}: engine vs its fake-quant model", out[:CPU_BATCH],
                             fq[:CPU_BATCH], QUANT_ATOL)
            fq_tol = QUANT_ATOL * max(1.0, fq[:CPU_BATCH].abs().max().item())
            cmp = _layers_vs_exact(name, engine, x[:CPU_BATCH])
            cmp.update(_layers_card_vs_cpu(name, engine, x[:CPU_BATCH]))
            fused_ms = _forward_ms(fused, x, ENGINE_ITERS)
            res = dict(batch=UPCAT_BATCH, chained=chained, engine_ms=engine_ms,
                       engine_img_s=UPCAT_BATCH / engine_ms * 1e3, fake_quant_ms=fused_ms,
                       fake_quant_img_s=UPCAT_BATCH / fused_ms * 1e3,
                       engine_vs_fake_quant_max_abs=fq_diff, engine_vs_fake_quant_tol=fq_tol,
                       engine_vs_fake_quant_max_abs_batch=(out - fq).abs().max().item(),
                       launches=launches, **cmp)
            report[name] = res
            _profile_engine(name, engine, x, report, profile_dir)
            log(f"{name}: engine at batch {UPCAT_BATCH}: {engine_ms:.3f} ms = "
                f"{res['engine_img_s']:.0f} img/s (fake-quant model {fused_ms:.3f} ms); "
                f"chained {chained}; vs fake-quant max|diff| {fq_diff:.3e} (tol {fq_tol:.3e}); "
                f"card = CPU on "
                f"{cmp['layers_equal']} layers bit for bit, output max|diff| "
                f"{cmp['logits_max_abs']:.3e}")


# ---------------------------------------------------------------- phase 18


# slice 7: the TinyDecoder of examples/serve_llm.py at that example's configuration, the
# widest the repo runs the model at, W4 at group 32 (so K/2 = 64 or 128 packed rows hold
# whole groups and every block linear reaches K3); the MoE form at the same widths with 8
# int8 experts, top-1 and top-2, drop-free. (label, experts, top_k)
DECODER_KW = dict(vocab=256, dim=128, heads=8, depth=4, mlp_dim=256, max_seq=64)
DECODER_GROUP = 32
DECODER_FORMS = [("dense", 0, 1), ("moe_top1", 8, 1), ("moe_top2", 8, 2)]
DECODER_PROMPT = [12, 99, 7, 45]  # examples/serve_llm.py's
DECODER_SLOTS = 4
# (prompt length, new tokens, decode steps run before it is submitted): mixed lengths, two
# arrivals after the loop started; six requests through four slots, so slots recycle
DECODER_REQUESTS = [(4, 8, 0), (2, 4, 0), (17, 12, 0), (9, 20, 0), (3, 5, 1), (30, 16, 3)]
DECODER_TF_STEPS = 24  # teacher-forced positions after the prompt
# whole-model logits, the card against the CPU: K3's sums in another order (2e-5 relative
# a matmul), and an activation within an f32 rounding of a bf16 boundary before a W4
# matmul moves one term by 2^-8 (MODEL_REL_TOL's cause); relative to max(1, max|logit|)
DECODER_CARD_CPU_TOL = MODEL_REL_TOL
# prefill against incremental decode: decode attention rounds q and p * v_scale to bf16,
# prefill attention stays f32 (tests/test_torch_tiny_decoder.py), relative as above
DECODER_PREFILL_TOL = 1e-2
# the K3 shapes of one decode step of one slot: (K, N) and calls per forward, dense (wq, wk,
# wv, wo, up, down per block) and MoE (wq, wk, wv, wo)
DECODER_K3 = {"dense": [((128, 128), 16), ((128, 256), 4), ((256, 128), 4)],
              "moe": [((128, 128), 16)]}


class _TimedForwardBatch(_Timed):
    """:class:`_Timed` for a model without a batched decode step: the loop
    steps through ``forward_batch``, timed as its decode steps."""

    decode_batch = None

    def forward_batch(self, *a):
        return self._time(self._m.forward_batch, self.decode_s, *a)


def _decoder(experts, top_k, dev, generator=None):
    """A float TinyDecoder of ``DECODER_KW``, its MoE blocks routing top-k."""
    from micronet_tpu_torch.models.tiny_decoder import TinyDecoder

    model = TinyDecoder(**DECODER_KW, moe_experts=experts, device=dev, generator=generator)
    for blk in model.blocks:
        if blk.moe is not None:
            blk.moe.top_k = top_k
    return model


def _decoder_pair(experts, top_k, dev, seed):
    """The float decoder and its W4 form (``quantize_decoder`` at group 32,
    int8 experts) with the same weights, from one generator."""
    import copy

    from micronet_tpu_torch.models.tiny_decoder import quantize_decoder

    float_model = _decoder(experts, top_k, dev, torch.Generator(device=dev).manual_seed(seed))
    return float_model, quantize_decoder(copy.deepcopy(float_model), group=DECODER_GROUP)


def _cpu_copy(model, experts, top_k):
    """The W4 ``model``'s weights in the same model on the CPU."""
    from micronet_tpu_torch.models.tiny_decoder import quantize_decoder

    cpu = quantize_decoder(_decoder(experts, top_k, "cpu"), group=DECODER_GROUP)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def _teacher_forced(model, tokens, n_prompt, prefill_all=False):
    """Logits (len(tokens), vocab) of a prefill of the first ``n_prompt``
    tokens, then one T = 1 forward for each later token (or, with
    ``prefill_all``, one prefill of them all), and each MoE block's router
    logits in that run, per block (positions, experts)."""
    rec = []
    hooks = [blk.moe.register_forward_hook(
        lambda m, inp, out, i=i: rec.append((i, (inp[0] @ m.router).cpu())))
        for i, blk in enumerate(model.blocks) if blk.moe is not None]
    toks = torch.tensor(tokens, device=model.device)
    n = len(tokens) if prefill_all else n_prompt
    logits, caches = model.forward(toks[:n], model.init_cache(), 0)
    rows = [logits]
    for i in range(n, len(tokens)):
        step, caches = model.forward(toks[i:i + 1], caches, i)
        rows.append(step)
    for h in hooks:
        h.remove()
    routers = {}
    for i, r in rec:
        routers.setdefault(i, []).append(r)
    return torch.cat(rows).cpu(), [torch.cat(v) for _, v in sorted(routers.items())]


def _first_route_flip(ra, rb, top_k, what):
    """The first position where a MoE block's top-k experts differ between
    two runs of the same stream (router logits ``ra``, ``rb`` per block),
    or None. Fails unless, at that block and position, the first run's
    k-th and (k + 1)-th router logits lie within twice the most any router
    logit moved between the runs there: a tie that the runs' rounding may
    break either way. Every position after it, in later blocks too, follows
    the other expert."""
    from micronet_tpu_torch.parallel.moe import _top_k

    flips = []
    for layer, (a, b) in enumerate(zip(ra, rb)):
        differ = (_top_k(a, top_k).sort(-1).values != _top_k(b, top_k).sort(-1).values).any(-1)
        if differ.any():
            flips.append((int(differ.nonzero()[0]), layer))
    if not flips:
        return None
    pos, layer = min(flips)
    top = ra[layer][pos].sort(descending=True).values
    margin = (top[top_k - 1] - top[top_k]).item()
    moved = (ra[layer][pos] - rb[layer][pos]).abs().max().item()
    if margin > 2 * moved:
        fail(f"{what}: block {layer} routes position {pos} to other experts, with a margin "
             f"{margin:.3e} over twice what its router logits moved ({moved:.3e})")
    return dict(position=pos, block=layer, margin=margin, router_moved=moved)


def decoder_card_vs_cpu(model, experts, top_k, what):
    """The card's W4 decoder against the same weights on the CPU (the
    wrappers' twins) under teacher forcing over the CPU's greedy stream
    after ``DECODER_PROMPT``: logits within ``DECODER_CARD_CPU_TOL`` at
    every position, the argmax equal wherever the CPU's top-2 margin
    exceeds twice that (``_agree``); positions where the card's argmax
    differs are listed. Then a prefill of the whole stream against that
    incremental decode, on the card, within ``DECODER_PREFILL_TOL``. A MoE
    block may route a token to other experts where its router sits at a
    tie (``_first_route_flip``); logits are then compared up to that
    position."""
    cpu = _cpu_copy(model, experts, top_k)
    n = len(DECODER_PROMPT)
    stream = DECODER_PROMPT + cpu.generate(torch.tensor(DECODER_PROMPT),
                                           DECODER_TF_STEPS).tolist()[:-1]
    ref, ref_routes = _teacher_forced(cpu, stream, n)
    got, routes = _teacher_forced(model, stream, n)
    if not torch.isfinite(got).all():
        fail(f"{what}: card logits not finite under teacher forcing")
    flip = _first_route_flip(ref_routes, routes, top_k, f"{what}: card vs CPU")
    upto = len(stream) if flip is None else flip["position"]
    diff = _agree(f"{what}: card vs CPU under teacher forcing", got[:upto], ref[:upto],
                  DECODER_CARD_CPU_TOL)
    swapped = (got[:upto].argmax(-1) != ref[:upto].argmax(-1)).nonzero().flatten().tolist()
    if swapped:
        log(f"{what}: the card's argmax differs from the CPU's at positions {swapped} "
            f"(top-2 margins within the tolerance)")
    full, full_routes = _teacher_forced(model, stream, n, prefill_all=True)
    pflip = _first_route_flip(full_routes, routes, top_k, f"{what}: prefill vs decode")
    pupto = len(stream) if pflip is None else pflip["position"]
    tol = DECODER_PREFILL_TOL * max(1.0, full.abs().max().item())
    pre = (got[:pupto] - full[:pupto]).abs().max().item()
    if pre > tol:
        fail(f"{what}: prefill of {len(stream)} tokens vs incremental decode on the card: "
             f"max|diff| {pre:.3e} > {tol:.3e} over its first {pupto} positions")
    for name, f in (("card vs CPU", flip), ("prefill vs decode", pflip)):
        if f is not None:
            log(f"{what}: {name}: block {f['block']} routes position {f['position']} to "
                f"other experts at a router tie (margin {f['margin']:.3e}, router logits "
                f"moved {f['router_moved']:.3e}); logits compared up to it")
    return dict(positions=len(stream), card_vs_cpu_max_abs=diff, card_vs_cpu_positions=upto,
                card_vs_cpu_route_flip=flip, argmax_swapped=swapped,
                prefill_vs_decode_max_abs=pre, prefill_vs_decode_tol=tol,
                prefill_vs_decode_positions=pupto, prefill_vs_decode_route_flip=pflip)


def decoder_kernel_times(dev, gen, report):
    """K3 and K5a at phase 18's shapes against their twins: K3 at M = 1 (a
    slot's decode forward) and the requests' prompt lengths (prefill, M
    up to 30) at the three (K, N) of the dense block, group 32; K5a at G =
    8 heads, R = 1, D = 16, S = 64 with bounds 0..64. Each timed by events
    and by device time beside its twin, one library call (``torch.matmul``
    on the dequantized bf16 weight; SDPA on the dequantized bf16 cache)
    and its bound. Returns the kernels-line figures for one decode step of
    one slot, dense and MoE."""
    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import int4_matmul as im

    g = DECODER_GROUP
    k3 = {}
    prefill_ms = sorted({p for p, _, _ in DECODER_REQUESTS} | {len(DECODER_PROMPT)})
    for (k, n), _ in DECODER_K3["dense"]:
        ncopy = copies_for(k // 2 * n + k // g * n * 4)
        weights = []
        for _ in range(ncopy):
            w = torch.randn((k, n), device=dev, generator=gen) * 0.05
            w_q, gs = im.quantize_int4_weight_grouped(w, g)
            weights.append((im.pack_int4_hl8(w_q), gs))
        w_bf16 = [(im.unpack_int4_hl8(p).float() * im.expand_gscale(s, g)).to(torch.bfloat16)
                  for p, s in weights]
        for m in (1,) + tuple(prefill_ms):
            x = torch.randn((m, k), device=dev, generator=gen)
            out = im.int4_matmul_grouped_hl8(x, *weights[0])
            ref = im.int4_matmul_grouped_hl8_ref(x, *weights[0])
            torch.cuda.synchronize()
            err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
            if not (torch.isfinite(out).all() and err <= K3_REL_TOL * scale):
                fail(f"K3 M={m} K={k} N={n} g={g}: max|err| {err:.3e} > {K3_REL_TOL} * "
                     f"{scale:.3e}")
            alone = im.int4_matmul_grouped_hl8(x[-1:].contiguous(), *weights[0])
            if not torch.equal(alone[0], out[-1]):
                fail(f"K3 M={m} K={k} N={n} g={g}: a row alone differs from its batch's")
            case = dict(m=m, k=k, n=n, group=g, regime=im._k3_regime(m, g), max_abs_err=err,
                        ref_max=scale)
            if m == 1:
                args = [(x, p, s) for p, s in weights]
                lib_args = [(x.to(torch.bfloat16), w) for w in w_bf16]
                bound, bound_by = _k3_bound(m, k, n, g)
                case.update(ms=time_ms(im.int4_matmul_grouped_hl8, args, 200),
                            plain_ms=time_ms(im.int4_matmul_grouped_hl8_ref, args, 50),
                            library_ms=time_ms(torch.matmul, lib_args, 200),
                            device_ms=device_ms(im.int4_matmul_grouped_hl8, args, 30),
                            library_device_ms=device_ms(torch.matmul, lib_args, 30),
                            bound_ms=bound, bound_by=bound_by)
                log(f"K3 M=1 K={k} N={n} g={g} (regime {case['regime']}): err {err:.3e} "
                    f"(tol {K3_REL_TOL * scale:.3e}), kernel {case['ms']:.4f} ms (device "
                    f"{case['device_ms']:.4f}), plain {case['plain_ms']:.4f} ms, torch.matmul "
                    f"bf16 {case['library_ms']:.4f} ms (device {case['library_device_ms']:.4f}), "
                    f"bound {case['bound_ms']:.5f} ms ({case['bound_by']})")
            k3[m, k, n] = case
        del weights, w_bf16
    log(f"K3 at the prefill's M {prefill_ms} (g={g}): max|err| "
        f"{max(c['max_abs_err'] for c in k3.values()):.3e}, every row alone = its batch's")
    # K5a: one T = 1 attend of one slot's layer
    heads, d, s = DECODER_KW["heads"], DECODER_KW["dim"] // DECODER_KW["heads"], \
        DECODER_KW["max_seq"]
    bound = torch.tensor([0, 1, 15, 16, 17, 33, s - 1, s], dtype=torch.int32, device=dev)
    caches = [(torch.randint(-127, 128, (heads, s, d), dtype=torch.int8, device=dev,
                             generator=gen),
               torch.rand((heads, s), device=dev, generator=gen) * 0.02 + 1e-3,
               torch.randint(-127, 128, (heads, s, d), dtype=torch.int8, device=dev,
                             generator=gen),
               torch.rand((heads, s), device=dev, generator=gen) * 0.02 + 1e-3)
              for _ in range(16)]
    q = torch.randn((heads, d), device=dev, generator=gen)
    args = [(*c, q, bound) for c in caches]
    got = da.decode_attend_q8kv(*args[0])
    ref = da.decode_attend_q8kv_ref(*args[0])
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= ATT_ABS_TOL) or got[0].abs().max() != 0:
        fail(f"K5a G={heads} R=1 D={d} S={s}: max|err| {err:.3e} > {ATT_ABS_TOL}, or bound 0 "
             f"not zero")
    lib, bnd = attention_yardsticks(q[:, None, :], *caches[0], bound)
    k5a = dict(ms=time_ms(da.decode_attend_q8kv, args, 200),
               plain_ms=time_ms(da.decode_attend_q8kv_ref, args, 50), library_ms=lib,
               device_ms=device_ms(da.decode_attend_q8kv, args, 30), max_abs_err=err, **bnd)
    log(f"K5a G={heads} R=1 D={d} S={s} (bounds 0..{s}, {bnd['visible_rows']} visible rows): "
        f"err {err:.3e} (tol {ATT_ABS_TOL}), kernel {k5a['ms']:.4f} ms (device "
        f"{k5a['device_ms']:.4f}), plain {k5a['plain_ms']:.4f} ms, sdpa bf16 {lib:.4f} ms, "
        f"bound {bnd['bound_ms']:.5f} ms")
    del caches
    report["decoder_kernels"] = dict(k3=[dict(v) for v in k3.values()], k5a=k5a)
    step = {}
    for form, shapes in DECODER_K3.items():
        step[form] = {key: sum(k3[1, k, n][key] * calls for (k, n), calls in shapes)
                      for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                  "library_device_ms", "bound_ms")}
    return dict(k3_per_slot_step=step, k3_max_abs_err=max(c["max_abs_err"] for c in k3.values()),
                k5a=k5a)


def serve_decoder(dev, seed, card, report, profile_dir=None):
    """Slice 7's main path: for the dense, MoE top-1 and MoE top-2 forms,
    the float decoder and its W4 form from one generator (the W4 logits'
    cosine against float on ``DECODER_PROMPT``), then the W4 model behind
    ``ServeLoop(max_slots=4)`` over mixed-length requests, two arriving
    late: counts zeroed just before the loop and read just after, K3
    ``depth x (6 dense, 4 MoE)`` and K5a ``depth`` times per forward of
    each slot at each decode step (idle slots step too), K3 also per
    prefill, no other kernel; every request's tokens equal its isolated
    ``generate`` bit for bit (both decode at M = 1 in regime A); then the
    card against the CPU (:func:`decoder_card_vs_cpu`); with ``--profile``
    a traced run of 5 decode steps at 4 busy slots."""
    from micronet_tpu_torch.serve import Request, ServeLoop

    kernels = _all_kernels()
    depth = DECODER_KW["depth"]
    rng = np.random.default_rng(seed)
    res, launches_by_form = {}, {}
    for label, experts, top_k in DECODER_FORMS:
        float_model, model = _decoder_pair(experts, top_k, dev, seed)
        prompt = torch.tensor(DECODER_PROMPT, device=dev)
        lf, _ = float_model.forward(prompt, float_model.init_cache(), 0)
        lq, _ = model.forward(prompt, model.init_cache(), 0)
        cos = (lf * lq).sum().item() / (lf.norm() * lq.norm()).item()
        del float_model
        reqs = [(Request(i, rng.integers(0, DECODER_KW["vocab"], p).tolist(), new), after)
                for i, (p, new, after) in enumerate(DECODER_REQUESTS)]
        timed = _TimedForwardBatch(model)
        loop = ServeLoop(timed, DECODER_SLOTS, device=dev)
        for kern in kernels:
            kern.launches = 0
        # -- the main path: the serving loop ----------------------------
        t0 = time.perf_counter()
        steps = 0
        while (any(after >= steps for _, after in reqs) or loop.queue
               or any(r is not None for r in loop.slot_req)):
            for r, after in reqs:
                if after == steps:
                    loop.submit(r)
            loop.step()
            steps += 1
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        # ----------------------------------------------------------------
        done = loop.finished
        if sorted(done) != list(range(len(reqs))):
            fail(f"decoder {label}: served {sorted(done)} of {len(reqs)} requests")
        steps, prefills = len(timed.decode_s), len(timed.prefill_s)
        per_fwd = depth * (4 if experts else 6)
        want = {k.__name__: 0 for k in kernels}
        want["int4_matmul_grouped_hl8"] = per_fwd * (prefills + DECODER_SLOTS * steps)
        want["decode_attend_q8kv"] = depth * DECODER_SLOTS * steps
        if launches != want:
            fail(f"decoder {label}: launch counts {launches}, expected {want}")
        for r, _ in reqs:
            iso = model.generate(torch.tensor(r.prompt, device=dev), r.max_new_tokens).tolist()
            if done[r.rid].output != iso or not all(0 <= t < DECODER_KW["vocab"] for t in iso):
                fail(f"decoder {label}: request {r.rid} served {done[r.rid].output} but alone "
                     f"{iso}")
        check = decoder_card_vs_cpu(model, experts, top_k, f"decoder {label}")
        tokens = sum(len(r.output) - 1 for r in done.values())
        step_ms = sorted(1e3 * x for x in timed.decode_s)
        r = dict(card=card, form=label, experts=experts, top_k=top_k, group=DECODER_GROUP,
                 cosine_w4_vs_float=cos, requests=len(reqs), slots=DECODER_SLOTS,
                 decode_steps=steps, prefills=prefills, serve_s=serve_s,
                 decode_tokens=tokens, decode_tok_s=tokens / sum(timed.decode_s),
                 step_ms_median=step_ms[len(step_ms) // 2], step_ms_max=step_ms[-1],
                 prefill_s=sum(timed.prefill_s),
                 k3_per_slot_step=per_fwd, k5a_per_slot_step=depth, launches=launches, **check)
        res[label] = r
        launches_by_form[label] = {k: launches[k] for k in ("int4_matmul_grouped_hl8",
                                                            "decode_attend_q8kv")}
        log(json.dumps({"phase": 18, **{k: r[k] for k in (
            "card", "form", "cosine_w4_vs_float", "decode_steps", "decode_tok_s",
            "step_ms_median", "step_ms_max", "prefill_s", "card_vs_cpu_max_abs",
            "argmax_swapped", "prefill_vs_decode_max_abs")}, "launches": launches_by_form[label]}))
        if profile_dir is not None:
            loop = ServeLoop(model, DECODER_SLOTS, device=dev)
            for q, _ in reqs[:DECODER_SLOTS]:
                loop.submit(Request(100 + q.rid, q.prompt, 20))
            loop.step()  # admits every slot
            loop.step()
            res[label]["profile"] = trace(loop.step, 5, f"decoder {label}: decode steps at "
                                 f"{DECODER_SLOTS} busy slots",
                                 profile_dir / f"chip_smoke_decoder_{label}_profile.txt")
        del model, loop, timed
    report["decoder"] = res
    return launches_by_form


# ---------------------------------------------------------------- phase 19

# bucket profiles (min, opt, max) of phase 9's two engines
DEPLOY_PROFILES = {"resnet18_w8a8": (1, 64, RESNET_BATCH), "nin_gc_w4a4": (1, 256, NIN_BATCH)}
# requests: then the largest bucket and 2.5x it (chunked through the largest)
DEPLOY_REQUESTS = (1, 5, 64, 300)
K1_KERNEL = "int8_small_kernel"  # K1's regime at the fc (N = 10)
EPILOGUE_KERNEL = "requant_epilogue"  # ops/csrc/requant_epilogue.cu, one a symmetric conv
# ops/csrc/patch_gather.cu: one a conv whose operand is no view, one an int8 shuffle
PATCH_KERNELS = ("patch_matrix_kernel", "patch_shuffle_kernel")
# the JAX package's bf16 bound (tests/test_infer.py::test_bf16_eval_mode): relative L2
BF16_REL_TOL = 0.05
# cli deploy: cli train's two steps (the synthetic set's 2,048 images at batch 1,024)
DEPLOY_TRAIN_BATCH, DEPLOY_CLI_BATCH = 1024, 64


def hand_kernel_names() -> set:
    """The name of every ``__global__`` function in ``ops/csrc/``."""
    from micronet_tpu_torch.ops import _build

    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu*")))
    return set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(", text, re.S))


def replay_kernels(graph, replays: int, hand: set) -> dict:
    """Kernel counts by name over ``replays`` replays of ``graph`` under
    ``torch.profiler``, retried with longer quiet pads (as
    :func:`device_ms`) until the trace holds a multiple of ``replays``
    kernels and each hand-written kernel (a name containing one of
    ``hand``) a multiple of ``replays`` times. Other names need not be
    multiples: in a run that had used the profiler before, a few of a
    replay's library kernels came back under another name (1,572
    kernels for 3 replays of 524, with some names off a multiple)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    for pad in TRACE_PADS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(replays):
                graph.replay()
            torch.cuda.synchronize()
            time.sleep(pad)
        counts = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)
        ours = {k: c for k, c in counts.items() if any(h in k for h in hand)}
        odd = {k[:80]: c for k, c in counts.items() if c % replays}
        if counts and sum(counts.values()) % replays == 0 and not any(
                c % replays for c in ours.values()):
            if odd:
                log(f"replay trace: names off a multiple of {replays} replays: {odd}")
            return dict(counts)
        log(f"replay trace (pads of {pad} s) held {sum(counts.values())} kernels for {replays} "
            f"replays; names off a multiple: {odd}")
    fail(f"torch.profiler did not record {replays} whole replays in {len(TRACE_PADS)} traces")


def _events_ms(fn, iters: int) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed_engine_class():
    """``CompiledEngine`` recording each bucket's capture seconds and the
    launch counts each capture added (the warm-up forwards' launches are
    outside it)."""
    from micronet_tpu_torch.infer import CompiledEngine

    class TimedEngine(CompiledEngine):
        def _capture(self, x):
            kernels = _all_kernels()
            before = [k.launches for k in kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._capture(x)
            torch.cuda.synchronize()
            self.__dict__.setdefault("capture_s", {})[x.shape[0]] = time.perf_counter() - t0
            self.__dict__.setdefault("capture_launches", {})[x.shape[0]] = {
                k.__name__: k.launches - b for k, b in zip(kernels, before) if k.launches != b}
            return out

    return TimedEngine


def _bit_equal(what, got, ref):
    if tuple(got.shape) != tuple(ref.shape) or not torch.equal(got, ref):
        diff = (got - ref).abs().max().item() if got.shape == ref.shape else float("nan")
        fail(f"{what}: not equal to the eager engine bit for bit (shape {tuple(got.shape)} vs "
             f"{tuple(ref.shape)}, max|diff| {diff:.3e})")


@torch.no_grad()
def deploy_buckets(name, engine, dev, seed, card, report):
    """One engine of phase 9 behind ``build_engine(profile=...)``: a CUDA
    graph per bucket, every request equal to the eager engine bit for bit,
    the launch counts of the captures, the kernels of one replay of each
    bucket by ``torch.profiler``, and times per bucket. Returns the
    compiled engine and the launch counts of the path (captures and
    requests; the warm-up forwards count too)."""
    import copy

    from micronet_tpu_torch.infer.deploy import profile_buckets
    from micronet_tpu_torch.infer.engine import IntConv2d

    lo, opt, hi = DEPLOY_PROFILES[name]
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    kernels = _all_kernels()
    for kern in kernels:
        kern.launches = 0
    # -- the main path: capture every bucket, then the requests -----------
    t0 = time.perf_counter()
    compiled = _timed_engine_class()(engine, sorted(set(profile_buckets(lo, hi)) | {opt}),
                                     (32, 32, 3), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    requests = (*DEPLOY_REQUESTS, hi, int(2.5 * hi))
    xs = {n: torch.randn((n, 32, 32, 3), device=dev, generator=gen) for n in requests}
    outs = {n: compiled(xs[n]) for n in requests}
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    # ----------------------------------------------------------------------
    for n in requests:
        _bit_equal(f"{name} deploy: batch {n}", outs[n], engine(xs[n]))
    again = compiled(xs[5])
    _bit_equal(f"{name} deploy: batch 5 again", again, outs[5])
    if again.data_ptr() == outs[5].data_ptr():
        fail(f"{name} deploy: two calls returned one tensor")
    card_cpu = _agree(f"{name} deploy: buckets on the card vs the engine on the CPU",
                      compiled(xs[300][:CPU_BATCH]).cpu(),
                      copy.deepcopy(engine).to("cpu")(xs[300][:CPU_BATCH].cpu()), CARD_CPU_TOL)
    hand = hand_kernel_names()
    per_bucket, k1_per_replay = {}, {}
    for b in compiled.buckets:
        graph, sx, _ = compiled._graphs[b]
        sx.copy_(torch.randn(sx.shape, device=dev, generator=gen))
        counts = replay_kernels(graph, 3, hand)
        ours = {k: c // 3 for k, c in counts.items() if any(h in k for h in hand)}
        k1_per_replay[b] = sum(c for k, c in ours.items() if K1_KERNEL in k)
        eager_ms = _events_ms(lambda: engine(sx), ENGINE_ITERS)
        replay_ms = _events_ms(graph.replay, ENGINE_ITERS)
        call_ms = _events_ms(lambda: compiled(sx), ENGINE_ITERS)
        per_bucket[b] = dict(eager_ms=eager_ms, replay_ms=replay_ms, call_ms=call_ms,
                             img_s=b / call_ms * 1e3, eager_img_s=b / eager_ms * 1e3,
                             capture_s=compiled.capture_s[b],
                             capture_launches=compiled.capture_launches[b],
                             hand_kernels_per_replay=ours,
                             kernels_per_replay=sum(counts.values()) // 3)
        log(f"{name} bucket {b:5d}: eager {eager_ms:8.3f} ms, replay {replay_ms:8.3f} ms, call "
            f"(copy in, replay, copy out) {call_ms:8.3f} ms = {b / call_ms * 1e3:9.0f} img/s; "
            f"capture {compiled.capture_s[b]:.3f} s; {sum(counts.values()) // 3} kernels a "
            f"replay, hand-written {ours}")
    # one conv epilogue kernel a symmetric conv in every replay, the patch gathers of phase 9's
    # eager forward, and besides them only K1
    convs = sum(isinstance(m, IntConv2d) and m.symmetric and m.w_symmetric
                for m in engine.modules())
    gathers = report[name]["patch_launches"] // report[name]["forwards"]

    def replay_count(v, names):
        return sum(c for k, c in v["hand_kernels_per_replay"].items()
                   if any(n in k for n in names))

    epilogues = {b: replay_count(v, (EPILOGUE_KERNEL,)) for b, v in per_bucket.items()}
    patches = {b: replay_count(v, PATCH_KERNELS) for b, v in per_bucket.items()}
    other = {b: [k for k in v["hand_kernels_per_replay"]
                 if not any(n in k for n in (EPILOGUE_KERNEL, K1_KERNEL) + PATCH_KERNELS)]
             for b, v in per_bucket.items()}
    if (any(n != convs for n in epilogues.values()) or any(n != gathers for n in patches.values())
            or any(other.values())):
        fail(f"{name} deploy: conv epilogue kernels per replay {epilogues}, expected {convs} "
             f"(one a symmetric conv); patch gathers {patches}, expected {gathers} (phase 9's "
             f"a forward); other hand-written kernels {other}")
    if name == "resnet18_w8a8":
        want = {"int8_matmul_dequant": 1}
        if any(v["capture_launches"] != want for v in per_bucket.values()):
            fail(f"{name} deploy: launch counts per capture "
                 f"{ {b: v['capture_launches'] for b, v in per_bucket.items()} }, expected {want}")
        if any(v != 1 for v in k1_per_replay.values()):
            fail(f"{name} deploy: K1 kernels per replay {k1_per_replay}, expected exactly one "
                 f"({K1_KERNEL})")
        if launches["int8_matmul_dequant"] != 3 * len(compiled.buckets) or any(
                v for k, v in launches.items() if k != "int8_matmul_dequant"):
            fail(f"{name} deploy: launch counts {launches}: expected K1 three times a bucket "
                 "(two warm-up forwards and the capture) and none in the requests' replays")
    elif any(launches.values()) or any(k1_per_replay.values()):
        fail(f"{name} deploy: a hand-written kernel other than the conv epilogue ran "
             f"({launches}, K1 per replay {k1_per_replay})")
    res = dict(card=card, buckets=list(compiled.buckets), requests=list(requests),
               build_s=build_s, launches=launches, k1_kernels_per_replay=k1_per_replay,
               epilogue_kernels_per_replay=epilogues, patch_kernels_per_replay=patches,
               card_vs_cpu_max_abs=card_cpu, per_bucket=per_bucket,
               flops=compiled.flops)
    report[f"{name}_deploy"] = res
    log(f"{name} deploy: {len(compiled.buckets)} buckets {compiled.buckets} built in "
        f"{build_s:.2f} s; requests {requests} equal to the eager engine bit for bit; launches "
        f"{ {k: v for k, v in launches.items() if v} }; card vs CPU on {CPU_BATCH} images "
        f"{card_cpu:.3e}")
    return compiled, res


def _with_record(data: bytes, **edits) -> bytes:
    """The artifact ``data`` with its device record edited, in memory."""
    import io

    from micronet_tpu_torch.infer import deploy

    program = torch.export.load(io.BytesIO(data))
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        deploy.RECORD: json.dumps({**deploy.artifact_record(data), **edits})})
    return buf.getvalue()


@torch.no_grad()
def deploy_artifact(engine, dev, seed, out_dir: Path, card, report):
    """``serialize_engine`` on the ResNet-18 engine at batch 512 (export
    and save timed apart), ``deserialize_engine``: its graph calls the K1
    operator once, its output equals the engine bit for bit, its forward
    time beside the engine's; an artifact whose record names another
    compute capability refuses to load."""
    from micronet_tpu_torch.infer import deploy

    path = out_dir / "resnet18_w8a8.pt2"
    times = {}
    real = torch.export.export, torch.export.save

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key] = time.perf_counter() - t0
            return out
        return run

    torch.export.export, torch.export.save = timed(real[0], "export_s"), timed(real[1], "save_s")
    try:
        data = deploy.serialize_engine(engine, batch=RESNET_BATCH, path=str(path),
                                       platforms=("cuda",))
    finally:
        torch.export.export, torch.export.save = real
    t0 = time.perf_counter()
    runner = deploy.deserialize_engine(str(path))
    times["load_s"] = time.perf_counter() - t0
    record = deploy.artifact_record(data)
    k1_nodes = [n for n in runner.program.graph.nodes
                if n.target is torch.ops.micronet_tpu_torch.int8_matmul_dequant.default]
    if len(k1_nodes) != 1:
        fail(f"deploy artifact: {len(k1_nodes)} calls of the K1 operator in its graph, expected 1")
    epilogue_nodes = sum(n.target is torch.ops.micronet_tpu_torch.requant_epilogue.default
                         for n in runner.program.graph.nodes)
    if epilogue_nodes != 20:
        fail(f"deploy artifact: {epilogue_nodes} calls of the conv epilogue operator in its "
             "graph, expected 20 (one a symmetric conv of ResNet-18)")
    x = torch.randn((RESNET_BATCH, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 20))
    _bit_equal("deploy artifact at batch 512", runner(x), engine(x))
    program_ms = _events_ms(lambda: runner(x), ENGINE_ITERS)
    engine_ms = _events_ms(lambda: engine(x), ENGINE_ITERS)
    cap = record["capability"]
    other = [cap[0] - 1, cap[1]]
    try:
        deploy.deserialize_engine(_with_record(data, capability=other))
    except RuntimeError as e:
        refused = str(e)
    else:
        fail(f"deploy artifact: a record naming sm_{other[0]}{other[1]} loaded on "
             f"sm_{cap[0]}{cap[1]}")
    res = dict(card=card, bytes=len(data), record=record, program_ms=program_ms,
               engine_ms=engine_ms, program_img_s=RESNET_BATCH / program_ms * 1e3,
               refused=refused, **times)
    report["resnet18_w8a8_artifact"] = res
    log(f"deploy artifact: {len(data)} bytes, record {record}; export {times['export_s']:.2f} s, "
        f"save {times['save_s']:.2f} s, load {times['load_s']:.2f} s; program {program_ms:.3f} ms "
        f"a forward at batch {RESNET_BATCH} (eager engine {engine_ms:.3f} ms), equal bit for "
        f"bit; a record of sm_{other[0]}{other[1]} refused: {refused}")
    return res


@torch.no_grad()
def deploy_bf16(fp32, dev, seed, card, report):
    """``to_bf16`` and ``bf16_runner`` on a copy of phase 9's float
    ResNet-18 (eval mode): f32 out, within ``BF16_REL_TOL`` relative L2 of
    the fp32 eval (TF32 off), img/s of both at batch 512."""
    import copy

    from micronet_tpu_torch.infer import bf16_runner, to_bf16

    x = torch.randn((RESNET_BATCH, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 21))
    model = to_bf16(copy.deepcopy(fp32))
    run = bf16_runner(model)
    y, ref = run(x), fp32(x)
    rel = ((y - ref).norm() / ref.norm()).item()
    if y.dtype != torch.float32 or rel >= BF16_REL_TOL:
        fail(f"bf16 resnet18: output {y.dtype}, relative L2 {rel:.3e} (bound {BF16_REL_TOL})")
    bf16_ms = _events_ms(lambda: run(x), ENGINE_ITERS)
    fp32_ms = _events_ms(lambda: fp32(x), ENGINE_ITERS)
    res = dict(card=card, batch=RESNET_BATCH, rel_l2=rel, bf16_ms=bf16_ms, fp32_ms=fp32_ms,
               bf16_img_s=RESNET_BATCH / bf16_ms * 1e3, fp32_img_s=RESNET_BATCH / fp32_ms * 1e3)
    report["resnet18_bf16"] = res
    log(f"bf16 resnet18: relative L2 to fp32 {rel:.3e}; {res['bf16_img_s']:.0f} img/s against "
        f"fp32 (TF32 off) {res['fp32_img_s']:.0f} img/s at batch {RESNET_BATCH}")
    return res


def deploy_cli(dev, seed, out_dir: Path, card, report):
    """``cli train`` writes a ResNet-18 IAO checkpoint (2 steps), ``cli
    deploy`` serializes its engine; the artifact loads and equals the
    engine built from the same checkpoint bit for bit."""
    from micronet_tpu_torch.infer import deserialize_engine, freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models.resnet import resnet18
    from micronet_tpu_torch.nn import eval_mode, prepare
    from micronet_tpu_torch.quant.config import QuantConfig
    from micronet_tpu_torch.train import load_state

    ck, art = out_dir / "resnet18_iao.npz", out_dir / "resnet18_cli.pt2"
    model = ["--model_type", 2, "--bn_fuse"]
    _, train_s = _cli(["train", "--device", str(dev), *model, "--method", "iao", "--epochs", 1,
                       "--train_batch_size", DEPLOY_TRAIN_BATCH, "--seed", seed, "--save", ck],
                      "train resnet18 for deploy")
    text, deploy_s = _cli(["deploy", "--device", str(dev), *model, "--model", ck, "--save", art,
                           "--batch", DEPLOY_CLI_BATCH], "deploy resnet18")
    cfg = QuantConfig(bn_fuse=True, **EXACT)
    q = prepare(resnet18(device=dev, generator=torch.Generator(device=dev).manual_seed(0)),
                cfg, inplace=True, device=dev)
    load_state(ck, q)
    with torch.no_grad():
        fused = eval_mode(fuse_bn_iao(q, cfg, device=dev))
        engine = eval_mode(freeze_int(fused, example_input=torch.zeros((1, 32, 32, 3),
                                                                          device=dev), device=dev))
        x = torch.randn((DEPLOY_CLI_BATCH, 32, 32, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed + 22))
        _bit_equal("cli deploy artifact", deserialize_engine(str(art))(x), engine(x))
    res = dict(card=card, train_s=train_s, deploy_s=deploy_s, bytes=art.stat().st_size)
    report["resnet18_cli_deploy"] = res
    log(f"cli deploy: train {train_s:.1f} s, deploy {deploy_s:.1f} s, {res['bytes']} bytes; "
        "the artifact equals the engine built from the checkpoint")
    return res


def k1_operator_times(dev, gen, report):
    """K1 at phase 7's fc call (512 x 512 x 10): the public wrapper
    (through the registered operator), the operator called alone, the
    launch without it (``_card_call``, the same kernel), the same
    implementation registered
    with ``torch.library.custom_op`` instead (the registration the port
    does not use: it checks its inputs' aliasing on every call), and one
    call captured in a CUDA graph and replayed, each by CUDA events."""
    from micronet_tpu_torch.ops import int_matmul as i8

    label, m, k, n, s_x, zp, qmin, qmax, iters = K1_CASES[0]
    args = k1_args(m, k, n, s_x, zp, qmin, qmax, dev, gen)
    op_ms = time_ms(i8.int8_matmul_dequant, [args], iters)
    registered_ms = time_ms(torch.ops.micronet_tpu_torch.int8_matmul_dequant, [args], iters)
    direct_ms = time_ms(lambda *a: i8._card_call(*a[:3], (a[3], a[4], qmin, qmax)), [args],
                        iters)
    custom = torch.library.custom_op(
        "chip_smoke::k1_custom_op", i8._k1_op, mutates_args=(),
        schema="(Tensor x, Tensor w_q, Tensor w_scale, Tensor x_scale, Tensor x_zero_point, "
               "float qmin, float qmax) -> Tensor")
    custom_op_ms = time_ms(custom, [args], iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        i8.int8_matmul_dequant(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = i8.int8_matmul_dequant(*args)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, i8.int8_matmul_dequant_ref(*args)):
        fail("K1 replayed: differs from its twin")
    replay_ms = _events_ms(graph.replay, iters)
    res = dict(m=m, k=k, n=n, op_ms=op_ms, registered_ms=registered_ms, direct_ms=direct_ms,
               custom_op_ms=custom_op_ms, replay_ms=replay_ms)
    report["k1_operator"] = res
    log(f"K1 at M={m} K={k} N={n}: the public wrapper {op_ms:.4f} ms, its registered operator "
        f"called alone {registered_ms:.4f} ms, launched without the operator {direct_ms:.4f} ms, "
        f"through a torch.library.custom_op {custom_op_ms:.4f} ms, one call in a replayed graph "
        f"{replay_ms:.4f} ms")
    return res


def deploy(engines, dev, seed, out_dir: Path, card, report, profile_dir=None):
    """Phase 19: the deploy end on phase 9's two engines. Returns K1's
    launch count over the ResNet-18 buckets' path."""
    from micronet_tpu_torch.utils import profiling

    chip, kind = profiling.current_chip(), torch.cuda.get_device_name(0)
    if chip.name != ("h100_pcie" if "pcie" in kind.lower() else "h100_sxm"):
        fail(f"profiling.current_chip(): {chip.name} for {kind}")
    log(f"profiling.current_chip(): {chip}")
    compiled = {name: deploy_buckets(name, engines[name]["engine"], dev, seed, card, report)[0]
                for name in DEPLOY_PROFILES}
    if profile_dir is not None:
        for name, eng in compiled.items():
            logdir = profile_dir / f"deploy_trace_{name}"
            with profiling.trace(str(logdir)):
                for _ in range(3):
                    eng._graphs[eng.buckets[-1]][0].replay()
                torch.cuda.synchronize()
            if not list(logdir.glob("*.pt.trace.json")):
                fail(f"{name} deploy: profiling.trace wrote no trace into {logdir}")
    del compiled
    torch.cuda.empty_cache()
    deploy_artifact(engines["resnet18_w8a8"]["engine"], dev, seed, out_dir, card, report)
    deploy_bf16(engines["resnet18_w8a8"]["fp32"], dev, seed, card, report)
    deploy_cli(dev, seed, out_dir, card, report)
    report["current_chip"] = chip.name
    return report["resnet18_w8a8_deploy"]["launches"]["int8_matmul_dequant"]


# ---------------------------------------------------------------- phase 20


# The lowered path against the exact one on the card, at the JAX package's
# own bounds for its lowerings (tests/test_bn_stats_bf16.py:161-237): a
# layer's output within a median relative deviation of 0.02 (over
# |exact| + 0.01), its BN running statistics within rtol 0.05 and atol
# 0.05, and a run's losses within rtol 0.05 and atol 0.01 step by step.
LOWERED_MEDIAN_REL, LOWERED_STAT_TOL, LOSS_RTOL, LOSS_ATOL = 0.02, 0.05, 0.05, 0.01
LOWERED_METHODS = {"iao": dict(bn_fuse=True), "dorefa": {}}
# the entry's forward on the card (bf16 codes) against the CPU (exact f32),
# relative to max(1, max|logit|): bf16 operands round a weight to 8
# significant bits, and an activation code may move at a .5 edge
ENTRY_RTOL = 5e-2
REMAT_STEPS = 2  # the first seeds the BN statistics, the second runs the EMA
REMAT_TIMED = 8  # steps timed back to back after those


def _pin_exact(model):
    """Every quantized layer of ``model`` on the exact path: each resolves
    its lowerings from its ``cfg`` at call time."""
    import dataclasses

    from micronet_tpu_torch.quant.config import QuantConfig

    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), QuantConfig):
            m.cfg = dataclasses.replace(m.cfg, **EXACT)
    return model


def _nin_gc_train_model(dev, seed, method, exact=False):
    """Full-width NIN-GC prepared for ``method`` in training mode, its
    weights from a CPU generator (the same on every device)."""
    from micronet_tpu_torch.models.nin_gc import Net
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    cfg = QuantConfig(**LOWERED_METHODS[method], **(EXACT if exact else {}))
    model = prepare(Net(device="cpu", generator=torch.Generator().manual_seed(seed)), cfg,
                    method=method, device="cpu")
    return train_mode(model).to(dev)


def lowered_layers_vs_exact(dev, seed, report):
    """Each quantized layer of full-width NIN-GC (IAO ``--bn_fuse`` and
    DoReFa, W8A8) under ``"auto"`` on the card against the same layer on
    the exact path: one training forward of each from the same state and
    the exact model's input to that layer at batch 256."""
    import copy

    from micronet_tpu_torch.nn import qat_dorefa, qat_iao

    types = (qat_iao.QuantBNFuseConv2d, qat_iao.QuantConv2d, qat_dorefa.QuantConv2d)
    x = torch.randn((TRAIN_BATCH, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 30))
    res = {}
    for method in LOWERED_METHODS:
        low = _nin_gc_train_model(dev, seed, method)
        exact = _pin_exact(copy.deepcopy(low))
        ex = dict(exact.named_modules())
        layers = [(n, m) for n, m in low.named_modules() if isinstance(m, types)]
        seen, handles = {}, []
        for n, _ in layers:
            handles.append(ex[n].register_forward_hook(
                lambda mod, inp, out, n=n: seen.__setitem__(n, (inp[0], out))))
        with torch.no_grad():
            exact(x)
            for h in handles:
                h.remove()
            rows = []
            for n, m in layers:
                xin, ref = seen[n]
                y = m(xin)
                rel = ((y - ref).abs() / (ref.abs() + 1e-2)).median().item()
                row = dict(layer=n, type=type(m).__name__, median_rel=rel,
                           max_abs=(y - ref).abs().max().item(),
                           exact_max_abs=ref.abs().max().item())
                if not rel < LOWERED_MEDIAN_REL:
                    fail(f"{method} {n}: lowered vs exact median relative deviation {rel:.3e}")
                if isinstance(m, qat_iao.QuantBNFuseConv2d):
                    for stat in ("running_mean", "running_var"):
                        a, b = getattr(m, stat), getattr(ex[n], stat)
                        if not torch.allclose(a, b, rtol=LOWERED_STAT_TOL, atol=LOWERED_STAT_TOL):
                            fail(f"{method} {n}: lowered {stat} differs from the exact path's "
                                 f"by {(a - b).abs().max().item():.3e}")
                        row[f"{stat}_max_abs"] = (a - b).abs().max().item()
                rows.append(row)
        res[method] = rows
        log(f"lowered vs exact, {method} NIN-GC at batch {TRAIN_BATCH}, {len(rows)} layers: "
            f"median relative deviation up to {max(r['median_rel'] for r in rows):.3e}"
            + (", running statistics up to "
               f"{max(r.get('running_var_max_abs', 0.0) for r in rows):.3e} (var), "
               f"{max(r.get('running_mean_max_abs', 0.0) for r in rows):.3e} (mean)"
               if method == "iao" else ""))
        del low, exact
    report["lowered_layers_vs_exact"] = res
    return res


def _trainer(model, dev, remat=False):
    from micronet_tpu_torch.train import TrainConfig, Trainer
    from micronet_tpu_torch.train import data as data_lib

    return Trainer(model, TrainConfig(batch_size=TRAIN_BATCH, log_every=0, remat=remat),
                   dataset=data_lib.load_cifar10(), device=dev)


def _batches(dev, seed, n):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((TRAIN_BATCH, 32, 32, 3), device=dev, generator=gen),
             torch.randint(0, 10, (TRAIN_BATCH,), device=dev, generator=gen))
            for _ in range(n)]


def lowering_profile(dev, seed, report):
    """By ``torch.profiler``: the forward convolutions of one full-width
    NIN-GC IAO ``--bn_fuse`` training step (batch 256) under ``"auto"``
    (one per ``QuantBNFuseConv2d``, bf16 operands) and on the exact path
    (two per layer, f32), the step's second (the first chooses cuDNN's
    algorithms)."""
    from torch.profiler import ProfilerActivity, profile

    from micronet_tpu_torch.nn import qat_iao

    res = {}
    for label, exact in (("lowered", False), ("exact", True)):
        model = _nin_gc_train_model(dev, seed, "iao", exact)
        n_layers = sum(isinstance(m, qat_iao.QuantBNFuseConv2d) for m in model.modules())
        tr = _trainer(model, dev)
        (x0, y0), (x1, y1) = _batches(dev, seed + 31, 2)
        tr.train_step(x0, y0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            tr.train_step(x1, y1)
            torch.cuda.synchronize()
        convs = [e for e in prof.events() if e.name == "aten::conv2d"]
        dtypes = sorted({str(d) for e in convs for d in (getattr(e, "input_dtypes", None)
                                                          or [])[:2]})
        kernels = [e.key for e in prof.key_averages()
                   if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
        bf16_kernels = sorted({k for k in kernels if "bf16" in k.lower()})
        res[label] = dict(layers=n_layers, forward_convs=len(convs), operand_dtypes=dtypes,
                          bf16_kernel_names=bf16_kernels[:8],
                          n_bf16_kernel_names=len(bf16_kernels))
        want = n_layers if label == "lowered" else 2 * n_layers
        if len(convs) != want:
            fail(f"profile {label}: {len(convs)} forward convolutions for {n_layers} "
                 f"QuantBNFuseConv2d, expected {want}")
        if label == "lowered" and (not bf16_kernels or (dtypes and dtypes != ["c10::BFloat16"])):
            fail(f"profile lowered: operands {dtypes}, bf16 kernels {bf16_kernels}")
        if label == "exact" and (bf16_kernels or (dtypes and dtypes != ["float"])):
            fail(f"profile exact: operands {dtypes}, bf16 kernels {bf16_kernels}")
        log(f"profile {label}: {len(convs)} forward convolutions in a training step for "
            f"{n_layers} QuantBNFuseConv2d, operand dtypes {dtypes or 'not recorded'}, "
            f"{len(bf16_kernels)} bf16 kernel names, e.g. {bf16_kernels[:2]}")
        del tr, model
    report["lowering_profile"] = res
    return res


def exact_runs_vs_lowered(dev, seed, out_dir: Path, card, report, train_res):
    """Phase 14's ``cli train`` of IAO ``--bn_fuse`` and DoReFa again with
    the same seed, the config pinned to the exact path: each step's loss
    against phase 14's lowered run, and both runs' img/s, step times and
    peak memory side by side."""
    import dataclasses

    from micronet_tpu_torch import cli

    res = {}
    quant_config = cli._quant_config
    cli._quant_config = lambda args: dataclasses.replace(quant_config(args), **EXACT)
    try:
        for label, flags in TRAIN_METHODS:
            if label not in LOWERED_METHODS:
                continue
            ck, metrics = (out_dir / f"nin_gc_{label}_exact{s}" for s in (".npz", ".jsonl"))
            metrics.unlink(missing_ok=True)
            torch.cuda.reset_peak_memory_stats()
            _cli(["train", "--device", str(dev), *flags, "--epochs", TRAIN_EPOCHS,
                  "--train_batch_size", TRAIN_BATCH, "--seed", seed, "--save", ck,
                  "--metrics", metrics], f"train {label} exact")
            ex = _train_numbers(metrics, TRAIN_BATCH)
            ex["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            low = train_res[label]
            lo, el = np.array(low["losses"]), np.array(ex["losses"])
            if lo.shape != el.shape or not np.all(
                    np.abs(lo - el) <= LOSS_ATOL + LOSS_RTOL * np.abs(el)):
                fail(f"train {label}: lowered losses {lo.tolist()} vs exact {el.tolist()}")
            keys = ("img_s", "step_ms_median", "step_ms_max", "peak_gb", "first_loss",
                    "last_loss")
            res[label] = dict(lowered={k: low[k] for k in keys}, exact={k: ex[k] for k in keys},
                              img_s_lowered_vs_exact=low["img_s"] / ex["img_s"],
                              loss_max_abs_diff=float(np.abs(lo - el).max()))
            log(json.dumps({"phase": 20, "model": "nin_gc", "method": label, "card": card,
                            "batch": TRAIN_BATCH, **res[label]}))
    finally:
        cli._quant_config = quant_config
    report["exact_runs_vs_lowered"] = res
    return res


def remat_step(dev, seed, report):
    """``remat=True`` against a plain step on full-width NIN-GC IAO
    ``--bn_fuse`` at batch 256 (``"auto"``: the lowerings): two steps each
    from the same weights on the same batches, every parameter, gradient
    and buffer equal bit for bit; then ``REMAT_TIMED`` more steps of each
    back to back (CUDA events: one step's launches overlap the last one's
    kernels, as in a run) with their peak memory."""
    models = [_nin_gc_train_model(dev, seed, "iao") for _ in range(2)]
    trainers = dict(zip(("plain", "remat"),
                        (_trainer(m, dev, remat=r) for m, r in zip(models, (False, True)))))
    for step, (x, y) in enumerate(_batches(dev, seed + 32, REMAT_STEPS)):
        for tr in trainers.values():
            tr.train_step(x, y)
        pairs = list(zip(models[1].named_parameters(), models[0].parameters()))
        for (name, a), b in pairs:
            if not (torch.equal(a, b) and torch.equal(a.grad, b.grad)):
                fail(f"remat step {step}: {name} or its gradient differs from the plain step")
        for (name, a), b in zip(models[1].named_buffers(), models[0].buffers()):
            if not torch.equal(a, b):
                fail(f"remat step {step}: buffer {name} differs from the plain step")
    res = dict(equal_arrays=2 * len(pairs) + len(list(models[0].buffers())))
    batches = _batches(dev, seed + 33, REMAT_TIMED)
    for label, tr in trainers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for x, y in batches:
            tr.train_step(x, y)
        end.record()
        torch.cuda.synchronize()
        res[label] = dict(step_ms=start.elapsed_time(end) / REMAT_TIMED,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["remat"] = res
    log(f"remat: {REMAT_STEPS} steps of full-width NIN-GC IAO --bn_fuse at batch {TRAIN_BATCH} "
        f"equal the plain steps in {res['equal_arrays']} parameters, gradients and buffers; "
        f"{REMAT_TIMED} steps back to back: {res['remat']['step_ms']:.2f} ms a step, peak "
        f"{res['remat']['peak_gb']:.2f} GB (plain {res['plain']['step_ms']:.2f} ms, "
        f"{res['plain']['peak_gb']:.2f} GB)")
    return res


def graft_entry_check(dev, seed, report):
    """``graft_entry.entry()``'s forward on the card twice (the same bits),
    against the same weights on the CPU (the exact path) within
    ``ENTRY_RTOL``; then the same after two training forwards on the card
    calibrate its observers and BN statistics (the CPU copy takes the
    card's state), on 8 random images."""
    from micronet_tpu_torch.graft_entry import entry
    from micronet_tpu_torch.nn import eval_mode, train_mode

    fn, args = entry()
    cpu_fn, cpu_args = entry("cpu")
    res = {}
    gen = torch.Generator(device=dev).manual_seed(seed + 33)
    with torch.no_grad():
        for label in ("initial", "calibrated"):
            if label == "calibrated":
                train_mode(fn)
                for _ in range(2):
                    fn(torch.randn((64, 32, 32, 3), device=dev, generator=gen) * 2)
                eval_mode(fn)
                cpu_fn.load_state_dict({k: v.cpu() for k, v in fn.state_dict().items()})
                x = torch.randn((8, 32, 32, 3), device=dev, generator=gen) * 2
                args, cpu_args = (x,), (x.cpu(),)
            a, b = fn(*args), fn(*args)
            ref = cpu_fn(*cpu_args)
            if not torch.equal(a, b):
                fail(f"graft entry ({label}): two forwards on the card differ")
            diff = (a.cpu() - ref).abs().max().item()
            tol = ENTRY_RTOL * max(1.0, ref.abs().max().item())
            if tuple(a.shape) != (args[0].shape[0], 10) or not diff <= tol:
                fail(f"graft entry ({label}): card vs CPU max|diff| {diff:.3e} (tol {tol:.3e})")
            res[label] = dict(card_vs_cpu_max_abs=diff, tol=tol,
                              argmax_agree=(a.cpu().argmax(-1) == ref.argmax(-1)).float()
                              .mean().item())
    report["graft_entry"] = res
    cal = res["calibrated"]
    log(f"graft entry: two forwards on the card equal; card (lowered) vs CPU (exact) max|diff| "
        f"{res['initial']['card_vs_cpu_max_abs']:.3e} at the example input, "
        f"{cal['card_vs_cpu_max_abs']:.3e} calibrated (tol {cal['tol']:.3e}, argmax "
        f"agreement {cal['argmax_agree']:.3f})")
    return res


def training_lowerings(dev, seed, out_dir: Path, card, report, train_res):
    """Phase 20: the training lowerings on the card (each check above)."""
    lowered_layers_vs_exact(dev, seed, report)
    lowering_profile(dev, seed, report)
    exact_runs_vs_lowered(dev, seed, out_dir, card, report, train_res)
    remat_step(dev, seed, report)
    graft_entry_check(dev, seed, report)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 21


# slice 10: data and tensor parallelism over torch.distributed, one process
# a card. The NCCL world is every card of the machine; on one card it is a
# world of 1 (every collective still launched), and two more ranks then
# share the card over gloo (NCCL refuses two ranks on one card)
PAR_ENGINE_BATCH = RESNET_BATCH  # ResNet-18 W8A8 engine requests (one bucket)
PAR_BATCHES = (TRAIN_BATCH, 1024)  # global training batches timed on more than one card
PAR_TIMED = 6  # training steps timed, after 2 untimed
# the shared-card DP step (2 x 128 against 1 x 256) block by block, and the
# tensor-parallel engine's logits: f32 sums in another order (the batch
# moments combined over ranks, a conv over fewer channels), TF32 off
PAR_RTOL = 1e-5
# the DP step's parameter gradients (the ranks' sum) on the card, x max|g|:
# cuDNN's weight-gradient convolution sums a weight's 128 x 32 x 32 terms a
# rank, against 256 x 32 x 32 in one process, in another order; NIN-GC's
# first layer (the largest |g|) came out 1.13e-4 x max|g| apart in two of
# four runs, 2.7e-6 in the others (its algorithm varies with the card's
# free memory), about f32's rounding of a sum of 262,144 terms
PAR_CARD_GRAD_RTOL = 1e-3


def _cut(t, shape, rank_of_dim):
    """``t`` (the single process's tensor) cut to a rank's ``shape``: each
    dim that differs takes the slice of the rank ``rank_of_dim(d)``."""
    for d, (a, b) in enumerate(zip(t.shape, shape)):
        if a != b:
            t = t.narrow(d, rank_of_dim(d) * b, b)
    return t


def _sharded_flips(rec_s, rec_h, dp_rank, tp_rank):
    """Out channels of a block (the whole model's numbering) touched by an
    IAO weight code, a sign, its STE mask or a ReLU's mask that a rank
    rounds otherwise than the single process; fails on a flip that is not
    at an edge. A weight sliced over the model axis is compared with the
    single process's slice, an activation with its rows."""
    from micronet_tpu_torch.nn import modules as M

    chans = set()
    for name, (m_h, x_h, out_h) in rec_h.items():
        m_s, x_s, out_s = rec_s[name]
        if getattr(m_h, "is_weight", False):
            def cut(t):
                return _cut(t, out_s.shape, lambda d: tp_rank)
            flipped = torch.round(out_s / m_s.scale) != cut(torch.round(out_h / m_h.scale))
            edge = cut(_near_half(x_h / m_h.scale - m_h.zero_point))
            local = flipped.reshape(flipped.shape[0], -1).any(1).nonzero().flatten()
            offset = tp_rank * out_s.shape[0] if out_s.shape[0] != out_h.shape[0] else 0
            chans |= set((local + offset).tolist())
        else:
            x_h = _cut(x_h, x_s.shape, lambda d: dp_rank)
            out_h = _cut(out_h, out_s.shape, lambda d: dp_rank)
            if isinstance(m_h, M.ReLU):
                flipped = (x_s > 0) != (x_h > 0)
                edge = x_h.abs() < SIGN_EDGE
            else:
                flipped = (out_s != out_h) | ((x_s.abs() < 1) != (x_h.abs() < 1))
                edge = (x_h.abs() < SIGN_EDGE) | ((x_h.abs() - 1).abs() < SIGN_EDGE)
            chans |= set(flipped.transpose(0, 1).reshape(flipped.shape[1], -1).any(1)
                         .nonzero().flatten().tolist())
        if bool((flipped & ~edge).any()):
            fail(f"parallel step: {name} rounds otherwise on a rank away from an edge")
    return chans


def sharded_step_vs_single(ref, sharded, mesh, x, y, rtol=PAR_RTOL, grad_rtol=None):
    """One training step of ``sharded`` (``ref``'s weights, sharded over
    ``mesh``: its rows of the batch on the data axis, its out channels on
    the model axis) against ``ref`` on the whole batch in this process,
    block by block, in the pattern of phase 14's card-vs-CPU step: each
    sharded block gets the single process's input to it (its rows) and
    gradient with respect to its output, and must give the single
    process's output, input gradient, parameter gradients (summed over the
    data axis; its slice on the model axis; within ``grad_rtol`` x
    max|g|, by default ``rtol``) and state after the step, within
    ``rtol``. Channels where a value rounds the other way at an edge
    leave the comparison. Every rank of the mesh calls it, under cuDNN's
    deterministic algorithms. Returns the numbers of the comparison."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False  # as the trainer's steps run
    try:
        return _sharded_step(ref, sharded, mesh, x, y, rtol, grad_rtol or rtol)
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def _sharded_step(ref, sharded, mesh, x, y, rtol, grad_rtol):
    import copy

    import torch.nn.functional as TF

    from micronet_tpu_torch.parallel.distributed import all_reduce_, batch_reduction
    from micronet_tpu_torch.parallel.sharding import axis_rank, axis_size, batch_group_for

    n = x.shape[0]
    dp, dp_rank, tp_rank = axis_size(mesh, "data"), axis_rank(mesh, "data"), axis_rank(mesh,
                                                                                        "model")
    group = batch_group_for(n, mesh)

    def rows(t):
        return _cut(t, (n // dp,) + tuple(t.shape[1:]), lambda d: dp_rank)

    blocks_h, blocks_s = list(ref.model.layers), list(sharded.model.layers)
    xs = [x]
    with torch.no_grad():
        for b in copy.deepcopy(ref).model.layers:
            xs.append(b(xs[-1]))
    logits = xs[-1].reshape(n, -1).requires_grad_()
    loss_h = TF.cross_entropy(logits, y)
    loss_h.backward()
    g = logits.grad.reshape(xs[-1].shape)
    grads = [None] * len(blocks_h)
    for i in reversed(range(len(blocks_h))):  # the single process's backward, block by block
        xi = xs[i].clone().requires_grad_()
        rec, handles = _quant_points(blocks_h[i])
        out = blocks_h[i](xi)
        for h in handles:
            h.remove()
        (out * g).sum().backward()
        grads[i] = (g, out.detach(), xi.grad, rec)
        g = xi.grad
    gmax = max(p.grad.abs().max().item() for p in ref.parameters())
    n_chan = skipped_gx = 0
    worst = dict(out=0.0, gx=0.0, grad=0.0, state=0.0)
    for i, (bh, bs) in enumerate(zip(blocks_h, blocks_s)):
        g, out_h, gx_h, rec_h = grads[i]
        xi = rows(xs[i]).clone().requires_grad_()
        rec_s, handles = _quant_points(bs)
        with batch_reduction(group):
            out = bs(xi)
        for h in handles:
            h.remove()
        (out * rows(g)).sum().backward()
        if i == len(blocks_s) - 1:
            loss_s = TF.cross_entropy(out.detach().reshape(out.shape[0], -1), rows(y))
            if group is not None:
                loss_s = all_reduce_(loss_s, "sum", group) / dp
        chans = _sharded_flips(rec_s, rec_h, dp_rank, tp_rank)
        n_chan += len(chans)
        keep = torch.ones(out_h.shape[1], dtype=torch.bool)
        keep[list(chans)] = False
        what = f"block {i} ({type(bh).__name__})"
        worst["out"] = max(worst["out"], _close_or_fail(
            what + " output", out.permute(1, 0, 2, 3), rows(out_h).permute(1, 0, 2, 3),
            rtol * max(1.0, out_h.abs().max().item()), keep))
        if chans:
            skipped_gx += 1
        else:
            worst["gx"] = max(worst["gx"], _close_or_fail(
                what + " input gradient", xi.grad, rows(gx_h),
                rtol * max(gx_h.abs().max().item(), 1e-30)))

        def kept(t_s, t_h):
            """``keep`` over ``t_s``'s out channels (dim 0), where it has them."""
            if not t_s.dim() or t_h.shape[0] != keep.shape[0]:
                return None
            k = t_s.shape[0]
            return keep[tp_rank * k:(tp_rank + 1) * k] if k != keep.shape[0] else keep

        for (name, ps), ph in zip(bs.named_parameters(), bh.parameters()):
            gs = ps.grad if group is None else all_reduce_(ps.grad, "sum", group)
            gh = _cut(ph.grad, gs.shape, lambda d: tp_rank)
            worst["grad"] = max(worst["grad"], _close_or_fail(
                f"{what} gradient of {name}", gs, gh, grad_rtol * gmax, kept(gs, ph)))
        for (name, ts), th in zip(bs.state_dict().items(), bh.state_dict().values()):
            th = _cut(th, ts.shape, lambda d: tp_rank)
            if th.dtype == torch.bool:
                if not torch.equal(ts.cpu(), th.cpu()):
                    fail(f"parallel step: {what} state {name} differs")
                continue
            worst["state"] = max(worst["state"], _close_or_fail(
                f"{what} state {name}", ts.float(), th.float(),
                rtol * max(1.0, th.abs().max().item()), kept(ts, th)))
    loss_s, loss_h = float(loss_s), float(loss_h.detach())
    rel = abs(loss_s - loss_h) / abs(loss_h)
    if not rel <= rtol:
        fail(f"parallel step: loss {loss_s:.7f} against the single process's {loss_h:.7f}")
    return dict(loss=loss_h, loss_rel_diff=rel, blocks=len(blocks_h),
                channels_at_an_edge=n_chan, blocks_without_input_grad_check=skipped_gx,
                gmax=gmax, **{f"max_abs_{k}": v for k, v in worst.items()})


def _par_init(rank, world, port, gloo):
    """This rank's process group: NCCL, one card a rank
    (``parallel.initialize``), or gloo with every rank on card 0."""
    import torch.distributed as dist

    from micronet_tpu_torch.parallel import initialize

    if gloo:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    else:
        initialize(f"tcp://localhost:{port}", world, rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _par_load_engine(dev, shared: Path):
    """Phase 19's ResNet-18 W8A8 engine, its input and its eager output."""
    eng = torch.load(shared / "engine.pt", weights_only=False, map_location=dev)
    x, ref = (t.to(dev) for t in torch.load(shared / "io.pt", map_location=dev))
    return eng, x, ref


def _par_engine(dev, shared: Path, mesh, bit_equal: bool):
    """Phase 19's engine behind ``build_engine(mesh=)`` with one bucket of
    ``PAR_ENGINE_BATCH``: K1's launches counted from the build (two
    warm-ups and a capture a bucket on the card, or eager forwards over
    gloo's channel gathers) to the last call, then one more eager
    forward of the sharded model alone (K1 once); the output against the
    eager engine's (bit for bit, or within ``PAR_RTOL``); a call's ms
    eager (every rank its rows, then the gather) and through the bucket."""
    import torch.distributed as dist

    from micronet_tpu_torch.infer import build_engine
    from micronet_tpu_torch.ops import int_matmul as i8
    from micronet_tpu_torch.parallel.distributed import _gather_parts
    from micronet_tpu_torch.parallel.sharding import shard_batch

    eng, x, ref = _par_load_engine(dev, shared)
    b = PAR_ENGINE_BATCH
    k1 = i8.int8_matmul_dequant
    k1.launches = 0
    # -- the main path: the sharded engine ---------------------------------
    ce = build_engine(eng, profile=(b, b, b), example_shape=(32, 32, 3), mesh=mesh, device=dev)
    out = ce(x)
    torch.cuda.synchronize()
    launches = k1.launches
    # ----------------------------------------------------------------------
    captured = bool(ce._graphs)
    want = 3 * len(ce.buckets) if captured else 1
    before = k1.launches
    with torch.no_grad():
        eng(shard_batch(x, mesh))
    torch.cuda.synchronize()
    if launches != want or k1.launches - before != 1:
        fail(f"parallel engine: K1 launched {launches} times over the build and a call "
             f"(expected {want}) and {k1.launches - before} in one eager forward")
    diff = (out - ref).abs().max().item()
    tol = 0.0 if bit_equal else PAR_RTOL * max(1.0, ref.abs().max().item())
    if tuple(out.shape) != tuple(ref.shape) or not diff <= tol:
        fail(f"parallel engine: max|diff| {diff:.3e} against the eager engine (tol {tol:.1e})")
    data = mesh.get_group("data")

    @torch.no_grad()
    def eager():
        return torch.cat(_gather_parts(eng(shard_batch(x, mesh)), data))

    dist.barrier()
    eager_ms = _events_ms(eager, ENGINE_ITERS)
    dist.barrier()
    call_ms = _events_ms(lambda: ce(x), ENGINE_ITERS)
    return dict(launches=launches, captured=captured, max_abs_diff=diff, bit_equal=diff == 0.0,
                eager_ms=eager_ms, eager_img_s=b / eager_ms * 1e3, call_ms=call_ms,
                call_img_s=b / call_ms * 1e3)


def _par_trainer(dev, seed, mesh, batch):
    from micronet_tpu_torch.train import TrainConfig, Trainer
    from micronet_tpu_torch.train import data as data_lib

    return Trainer(_nin_gc_train_model(dev, seed, "iao"),
                   TrainConfig(batch_size=batch, log_every=0, seed=seed),
                   dataset=data_lib.load_cifar10(), mesh=mesh, device=dev)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _equal_states(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


def _par_trainer_equal(dev, seed, mesh):
    """Phase 14's IAO ``--bn_fuse`` run (one epoch: 8 steps at batch 256,
    the ``"auto"`` lowerings) through ``Trainer(mesh=)`` and without a mesh
    from the same seed: the same state bit for bit."""
    runs = {}
    for label, m in (("single", None), ("mesh", mesh)):
        tr = _par_trainer(dev, seed, m, TRAIN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.train_epoch(0, log=lambda _msg: None)
        torch.cuda.synchronize()
        runs[label] = (loss, _state(tr.model), time.perf_counter() - t0)
    differ = _equal_states(runs["single"][1], runs["mesh"][1])
    if differ or runs["single"][0] != runs["mesh"][0]:
        fail(f"Trainer(mesh=make_mesh(1, 1)): epoch loss {runs['mesh'][0]} against "
             f"{runs['single'][0]}; {len(differ)} arrays differ, e.g. {differ[:4]}")
    return dict(equal_arrays=len(runs["mesh"][1]), epoch_loss=runs["mesh"][0],
                seconds_single=runs["single"][2], seconds_mesh=runs["mesh"][2])


def _par_batches(dev, seed, batch, n):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randint(0, 256, (batch, 32, 32, 3), device=dev, generator=gen,
                           dtype=torch.uint8).float() / 255.0,
             torch.randint(0, 10, (batch,), device=dev, generator=gen)) for _ in range(n)]


def _par_step_ms(tr, batches):
    """ms a step over ``batches`` after the first two (CUDA events)."""
    import torch.distributed as dist

    for x, y in batches[:2]:
        tr.train_step(x, y)
    if tr.mesh is not None:
        dist.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x, y in batches[2:]:
        tr.train_step(x, y)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(batches) - 2)


def _nccl_share(tr, batches):
    """The NCCL kernels' share of the device time of two traced steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, y in batches[:2]:
            tr.train_step(x, y)
        torch.cuda.synchronize()
    total = nccl = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        total += t
        if "nccl" in e.key.lower():
            nccl += t
    return dict(nccl_ms=nccl / 1e3 / 2, device_ms=total / 1e3 / 2,
                nccl_share=nccl / total if total else float("nan"))


def _par_mesh_numbers(dev, seed, mesh, shared: Path, profile: bool):
    """At a (data, model) mesh of the whole world: training ms a step and
    img/s at each of ``PAR_BATCHES`` (global), whether two same-seed runs
    give the same state, the NCCL share of a traced step, and the ResNet-18
    engine at ``PAR_ENGINE_BATCH`` (bit for bit without a model axis)."""
    import torch.distributed as dist

    from micronet_tpu_torch.parallel.distributed import all_reduce_
    from micronet_tpu_torch.parallel.sharding import axis_size

    res = {}
    for batch in PAR_BATCHES:
        tr = _par_trainer(dev, seed, mesh, batch)
        ms = _par_step_ms(tr, _par_batches(dev, seed + 40, batch, PAR_TIMED + 2))
        res[f"train_b{batch}"] = dict(step_ms=ms, img_s=batch / ms * 1e3)
        if profile and batch == PAR_BATCHES[0]:
            res["nccl"] = _nccl_share(tr, _par_batches(dev, seed + 41, batch, 2))
        del tr
    states = []
    for _ in range(2):
        tr = _par_trainer(dev, seed, mesh, TRAIN_BATCH)
        tr.train_epoch(0, log=lambda _msg: None)
        states.append(_state(tr.model))
        del tr
    differ = torch.tensor(float(len(_equal_states(*states))), device=dev)
    res["repeat_arrays_differ"] = int(all_reduce_(differ, "sum", dist.group.WORLD).item())
    res["engine"] = _par_engine(dev, shared, mesh, bit_equal=axis_size(mesh, "model") == 1)
    torch.cuda.empty_cache()
    return res


def _par_single_card(dev, seed, shared: Path):
    """Rank 0 alone on its card, without a mesh: training img/s at each of
    ``PAR_BATCHES`` and the engine's eager and bucket ms at
    ``PAR_ENGINE_BATCH``."""
    from micronet_tpu_torch.infer import build_engine

    res = {}
    for batch in PAR_BATCHES:
        tr = _par_trainer(dev, seed, None, batch)
        ms = _par_step_ms(tr, _par_batches(dev, seed + 40, batch, PAR_TIMED + 2))
        res[f"train_b{batch}"] = dict(step_ms=ms, img_s=batch / ms * 1e3)
        del tr
    eng, x, ref = _par_load_engine(dev, shared)
    b = PAR_ENGINE_BATCH
    with torch.no_grad():
        eager_ms = _events_ms(lambda: eng(x), ENGINE_ITERS)
    ce = build_engine(eng, profile=(b, b, b), example_shape=(32, 32, 3), device=dev)
    call_ms = _events_ms(lambda: ce(x), ENGINE_ITERS)
    res["engine"] = dict(eager_ms=eager_ms, eager_img_s=b / eager_ms * 1e3, call_ms=call_ms,
                         call_img_s=b / call_ms * 1e3)
    return res


def _par_nccl_rank(rank, world, port, shared: Path, seed, profile):
    """One NCCL rank of phase 21 (the world is every card): on one card,
    ``Trainer(mesh=make_mesh(1, 1))`` equal to the trainer without a mesh
    and the engine through ``build_engine(mesh=)`` equal to phase 19's;
    on more, the numbers of :func:`_par_mesh_numbers` at dp = world and at
    dp = world / 2 x tp = 2, beside rank 0's single-card numbers."""
    import torch.distributed as dist

    from micronet_tpu_torch.parallel import make_mesh

    dev = _par_init(rank, world, port, gloo=False)
    res = dict(world=world, backend=dist.get_backend())
    if world == 1:
        mesh = make_mesh(1, 1)
        res["trainer"] = _par_trainer_equal(dev, seed, mesh)
        res["engine"] = _par_engine(dev, shared, mesh, bit_equal=True)
    else:
        if rank == 0:
            res["single_card"] = _par_single_card(dev, seed, shared)
        dist.barrier()
        for d, m in ((world, 1), (world // 2, 2)):
            res[f"dp{d}_tp{m}"] = _par_mesh_numbers(dev, seed, make_mesh(d, m), shared, profile)
    if rank == 0:
        (shared / "nccl.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _par_gloo_rank(rank, world, port, shared: Path, seed):
    """One of two gloo ranks sharing card 0: the DP step of full-width
    NIN-GC IAO ``--bn_fuse`` (the exact path) at 2 x 128 against one
    process at 256, block by block; the ResNet-18 engine at dp = 2 (bit for
    bit) and tp = 2 (within ``PAR_RTOL``)."""
    import copy

    import torch.distributed as dist

    from micronet_tpu_torch.parallel import make_mesh
    from micronet_tpu_torch.train import data as data_lib

    dev = _par_init(rank, world, port, gloo=True)
    dp_mesh, tp_mesh = make_mesh(2, 1), make_mesh(1, 2)
    ref = _nin_gc_train_model(dev, seed, "iao", exact=True)
    sharded = copy.deepcopy(ref)
    ds = data_lib._synthetic(TRAIN_BATCH, 1)
    gen = torch.Generator().manual_seed(seed)
    x = data_lib.augment_batch(gen, torch.from_numpy(ds[0])).permute(0, 3, 1, 2).to(dev)
    y = torch.from_numpy(ds[1].astype(np.int64)).to(dev)
    res = dict(step=sharded_step_vs_single(ref, sharded, dp_mesh, x, y,
                                           grad_rtol=PAR_CARD_GRAD_RTOL),
               engine_dp=_par_engine(dev, shared, dp_mesh, bit_equal=True),
               engine_tp=_par_engine(dev, shared, tp_mesh, bit_equal=False))
    if rank == 0:
        (shared / "gloo.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _spawn(fn, nprocs, *args):
    """``fn(rank, nprocs, port, *args)`` in ``nprocs`` fresh processes;
    fails if one fails (the others are stopped)."""
    import socket

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        mp.start_processes(fn, args=(nprocs, port, *args), nprocs=nprocs, start_method="spawn")
    except ProcessException as e:
        fail(f"phase 21: {e}")


@torch.no_grad()
def keep_parallel_engine(engine, dev, seed, out_dir: Path) -> Path:
    """Phase 19's ResNet-18 engine, an input of ``PAR_ENGINE_BATCH`` images
    and its eager output, saved for phase 21's ranks."""
    shared = out_dir / "phase21"
    shared.mkdir(parents=True, exist_ok=True)
    for m in engine.modules():
        if hasattr(m, "_gemm_cache"):
            m._gemm_cache = None
    x = torch.randn((PAR_ENGINE_BATCH, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 21))
    torch.save(engine, shared / "engine.pt")
    torch.save((x, engine(x)), shared / "io.pt")
    return shared


def parallel(dev, seed, shared: Path, card: str, report, profile: bool):
    """Phase 21: data and tensor parallelism (each check above). Returns
    K1's launches over the NCCL ranks' engine path (rank 0's)."""
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    _spawn(_par_nccl_rank, world, shared, seed, profile)
    nccl = json.loads((shared / "nccl.json").read_text())
    t1 = time.perf_counter()
    _spawn(_par_gloo_rank, 2, shared, seed)
    gloo = json.loads((shared / "gloo.json").read_text())
    res = dict(card=card, nccl=nccl, gloo=gloo, nccl_seconds=t1 - t0,
               gloo_seconds=time.perf_counter() - t1)
    report["parallel"] = res
    if world == 1:
        log(f"parallel (NCCL, world 1): Trainer(mesh=make_mesh(1, 1)) 8 steps of full-width "
            f"NIN-GC IAO --bn_fuse at batch {TRAIN_BATCH} equal the trainer without a mesh in "
            f"{nccl['trainer']['equal_arrays']} arrays; build_engine(mesh=) equals phase 19's "
            f"eager ResNet-18 engine bit for bit, K1 {nccl['engine']['launches']} launches "
            f"over the build and a call ({res['nccl_seconds']:.1f} s)")
        k1 = nccl["engine"]["launches"]
    else:
        k1 = nccl[f"dp{world}_tp1"]["engine"]["launches"]
        one = nccl["single_card"]
        for key in (f"dp{world}_tp1", f"dp{world // 2}_tp2"):
            r = nccl[key]
            log(json.dumps({"phase": 21, "mesh": key, "card": card, **{
                f"train_b{b}_img_s": r[f"train_b{b}"]["img_s"] for b in PAR_BATCHES}, **{
                f"train_b{b}_vs_one_card": r[f"train_b{b}"]["img_s"]
                / one[f"train_b{b}"]["img_s"] for b in PAR_BATCHES},
                "engine_eager_img_s": r["engine"]["eager_img_s"],
                "engine_call_img_s": r["engine"]["call_img_s"],
                "engine_bit_equal": r["engine"]["bit_equal"],
                "repeat_arrays_differ": r["repeat_arrays_differ"],
                "nccl_share": r.get("nccl", {}).get("nccl_share")}))
        log(json.dumps({"phase": 21, "mesh": "one card", "card": card, **{
            f"train_b{b}_img_s": one[f"train_b{b}"]["img_s"] for b in PAR_BATCHES},
            "engine_eager_img_s": one["engine"]["eager_img_s"],
            "engine_call_img_s": one["engine"]["call_img_s"]}))
    st = gloo["step"]
    log(f"parallel (gloo, two ranks on card 0): the DP step of full-width NIN-GC at 2 x "
        f"{TRAIN_BATCH // 2} against one process at {TRAIN_BATCH}, block by block: loss rel "
        f"diff {st['loss_rel_diff']:.2e}, max|diff| out {st['max_abs_out']:.2e}, input grads "
        f"{st['max_abs_gx']:.2e}, grads {st['max_abs_grad']:.2e} "
        f"({st['max_abs_grad'] / st['gmax']:.2e} x max|g| {st['gmax']:.2e}), "
        f"state {st['max_abs_state']:.2e}; {st['channels_at_an_edge']} channels at an edge "
        f"left out; engine dp=2 bit-equal, tp=2 max|diff| "
        f"{gloo['engine_tp']['max_abs_diff']:.3e} ({res['gloo_seconds']:.1f} s)")
    return k1


# ---------------------------------------------------------------- phase 22


# slice 11: tensor-parallel W4 serving, expert, sequence and pipeline parallelism, one
# process a card. The NCCL world is every card of the machine: on one card a world of 1
# (the W4 Llama's loop through a (1, 1) mesh, bit for bit the unsharded loop), then two
# gloo ranks share card 0 for the rest; on four cards the NCCL ranks run it all
SRV_DEPTH_SHARED = 4  # Llama blocks when two ranks share card 0 (32 on their own cards)
SRV_SLOTS, SRV_REQUESTS, SRV_NEW = 8, 12, 16  # phase 5's kind: prompts of 16 to 256 tokens
SRV_PROMPTS = (16, 256)
# TP logits against the unsharded model's: JAX's bound (__graft_entry__.py:155, :395): a
# column slice may take another K-split of K3 (_w4_splits depends on N), so f32 sums in
# another order; |a - b| <= atol + rtol |b|
SRV_TP_RTOL = SRV_TP_ATOL = 1e-4
SRV_EP_ATOL = 2e-5  # the EP MoE decoder against dense (__graft_entry__.py:342)
SRV_SP_ATOL = 2e-5  # the SP prefill against the dense prefill (:287)
SRV_RTOL = 1e-5  # EP MoE and ring attention forward and backward against dense (:256, :311)
SRV_PIPE_RTOL = 1e-3  # the quantized pipeline's loss against the fold (:228)
# the pipeline's gradients and state against the fold, x max|.|: cuDNN's weight-gradient
# convolutions sum in another order on another card (PAR_CARD_GRAD_RTOL's cause); the state
# is the forward's, the same kernels on the same inputs
SRV_PIPE_GRAD_RTOL, SRV_PIPE_STATE_RTOL = 1e-3, 1e-5
SRV_PIPE_C, SRV_PIPE_MICRO, SRV_PIPE_SIZE = 192, 64, 8  # NIN's seventh block on 8x8 maps
SRV_SP_PROMPTS, SRV_SP_STEPS = (64, 32), 16
SRV_EP_STEPS = 16
SRV_TIMED = 3  # repeats of each timed prefill and pipeline step


def _compare_row(a, b, atol, rtol):
    """Row ``a`` against the reference row ``b``: (max|a - b|, whether an
    element lies outside ``atol + rtol |b|``, and where the argmaxes differ
    the reference's top-2 gap and twice the bound at its top: a near tie
    when the gap lies within it, else None)."""
    diff = (a.float() - b.float()).abs()
    outside = bool((diff > atol + rtol * b.float().abs()).any())
    tie = None
    if int(a.argmax()) != int(b.argmax()):
        top = torch.topk(b.float(), 2).values
        tie = dict(ref_gap=(top[0] - top[1]).item(),
                   tie_bound=2 * (atol + rtol * top[0].abs().item()))
    return diff.max().item(), outside, tie


class _Rec(_Timed):
    """:class:`_Timed` that keeps (``ref`` None) or checks against ``ref``
    the logits each slot's request gets from every prefill and decode
    step, until that request's greedy token first differs: there it
    records the output position and the reference's top-2 gap, which must
    lie within twice the tolerance (a near tie)."""

    def __init__(self, model, ref=None, rtol=0.0, atol=0.0):
        super().__init__(model)
        self.ref, self.rtol, self.atol = ref, rtol, atol
        self.loop, self.admitting = None, None
        self.calls, self.i = [], 0
        self.max_abs, self.violations, self.diverged = 0.0, 0, {}

    def attach(self, loop):
        self.loop = loop
        admit = loop._admit

        def tracked(slot, req):
            self.admitting = req
            return admit(slot, req)

        loop._admit = tracked
        return loop

    def _rows(self, logits, prefill):
        if prefill:
            req = self.admitting
            return [(req.rid, len(req.output))], logits[-1:].detach()
        reqs = self.loop.slot_req
        keys = [(r.rid, len(r.output)) if r is not None else None for r in reqs]
        return keys, logits[:, 0].detach()

    def _see(self, logits, prefill):
        keys, rows = self._rows(logits, prefill)
        if self.ref is None:
            self.calls.append((keys, rows))
            return
        rkeys, rrows = self.ref.calls[self.i]
        self.i += 1
        if rkeys != keys:
            fail(f"phase 22: the loops' schedules differ at call {self.i}: {keys} vs {rkeys}")
        for j, key in enumerate(keys):
            if key is None or key[0] in self.diverged:
                continue
            diff, outside, tie = _compare_row(rows[j], rrows[j], self.atol, self.rtol)
            self.max_abs = max(self.max_abs, diff)
            self.violations += int(outside)
            if tie is not None:
                self.diverged[key[0]] = dict(position=key[1], **tie)

    def forward(self, *a):
        out = super().forward(*a)
        self._see(out[0], True)
        return out

    def decode_batch(self, *a):
        out = super().decode_batch(*a)
        self._see(out[0], False)
        return out

    def decode_batch_paged(self, *a):
        out = super().decode_batch_paged(*a)
        self._see(out[0], False)
        return out

    def forward_batch(self, *a):
        out = self._time(self._m.forward_batch, self.decode_s, *a)
        self._see(out[0], False)
        return out

    def verdict(self, what):
        """The comparison's numbers; fails on a logit outside the bound or a
        token that left the reference away from a near tie."""
        if self.ref is None:
            return {}
        bad = {r: d for r, d in self.diverged.items() if d["ref_gap"] > d["tie_bound"]}
        if self.violations or bad or self.i != len(self.ref.calls):
            fail(f"{what}: {self.violations} rows outside the bound (max|diff| "
                 f"{self.max_abs:.3e}), tokens left the reference away from a tie: {bad}, "
                 f"{self.i} of {len(self.ref.calls)} calls")
        first = min((d["position"] for d in self.diverged.values()), default=None)
        return dict(max_abs_diff=self.max_abs, compared_calls=self.i,
                    diverged_requests=len(self.diverged), first_tie_position=first,
                    diverged=self.diverged)


class _TimedDecoder(_Rec):
    decode_batch = None  # the TinyDecoder steps through forward_batch


def _srv_requests(seed, vocab):
    from micronet_tpu_torch.serve import Request

    rng = np.random.default_rng(seed + 22)
    lens = rng.integers(SRV_PROMPTS[0], SRV_PROMPTS[1] + 1, SRV_REQUESTS)
    lens[0], lens[1] = SRV_PROMPTS
    return [Request(i, [int(t) for t in rng.integers(0, vocab, n)], SRV_NEW)
            for i, n in enumerate(lens)]


def _srv_loop(model, reqs, dev, paged, ref=None, rtol=0.0, atol=0.0, slots=SRV_SLOTS,
              rec_cls=_Rec):
    """``reqs`` (fresh copies) through a ``ServeLoop`` over ``model``,
    recorded or checked against ``ref``: (outputs, recorder, wall s)."""
    from micronet_tpu_torch.serve import Request, ServeLoop

    rec = rec_cls(model, ref, rtol, atol)
    loop = rec.attach(ServeLoop(rec, slots, device=dev, paged=paged, page_size=PAGE))
    for r in reqs:
        loop.submit(Request(r.rid, list(r.prompt), r.max_new_tokens))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(done) != [r.rid for r in reqs]:
        fail(f"phase 22: served {sorted(done)} of {len(reqs)} requests")
    return {rid: r.output for rid, r in done.items()}, rec, wall


def _srv_stats(rec, wall, n_tokens):
    step_ms = sorted(1e3 * x for x in rec.decode_s)
    return dict(wall_s=wall, decode_steps=len(step_ms), prefills=len(rec.prefill_s),
                prefill_ms=1e3 * sum(rec.prefill_s), decode_tok_s=n_tokens / sum(rec.decode_s),
                step_ms_median=step_ms[len(step_ms) // 2], step_ms_max=step_ms[-1])


def _srv_counts(kernels):
    return {k.__name__: k.launches for k in kernels}


def _srv_llama(dev, seed, mesh, depth):
    """The W4 Llama-3-8B (``depth`` blocks) tensor-parallel over ``mesh``'s
    ``model`` axis behind the dense and the paged ``ServeLoop(8)``, then
    ``generate`` on request 0's prompt: on rank 0 first the unsharded
    model's loops (the single-card numbers and the reference), then every
    rank the sharded loops, logits within 1e-4 and tokens up to the first
    near tie, K3, K4a, K6 and K5a counted exactly."""
    import dataclasses

    import torch.distributed as dist

    from micronet_tpu_torch.models.llama import Llama, llama3_8b
    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import int4_matmul as im
    from micronet_tpu_torch.ops import paged_attention as pa
    from micronet_tpu_torch.parallel import shard_state
    from micronet_tpu_torch.parallel.sharding import axis_size

    cfg = dataclasses.replace(llama3_8b(2048), n_layers=depth)
    tp = axis_size(mesh, "model")
    t0 = time.perf_counter()
    model = Llama(cfg, w4_group=GROUP, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = _srv_requests(seed, cfg.vocab)
    tokens = SRV_REQUESTS * (SRV_NEW - 1)
    prompt = torch.tensor(reqs[0].prompt, device=dev)
    res = dict(depth=depth, tp=tp, build_s=build_s, prompt_lens=[len(r.prompt) for r in reqs])
    refs = {}
    if dist.get_rank() == 0:
        for paged in (False, True):
            out, rec, wall = _srv_loop(model, reqs, dev, paged)
            refs[paged] = (out, rec)
            res["one_card_paged" if paged else "one_card"] = _srv_stats(rec, wall, tokens)
        refs["generate"] = model.generate(prompt, SRV_NEW).tolist()
    dist.barrier()
    shard_state(model, mesh)
    k3, k4a, k5a, k6 = (im.int4_matmul_grouped_hl8, da.decode_attend_q8kv_cur,
                        da.decode_attend_q8kv, pa.paged_decode_attend_cur)
    kernels = (k3, k4a, k5a, k6)
    per_fwd = 4 * depth + 1
    for paged in (False, True):
        ref = refs.get(paged, (None, None))[1]
        for k in kernels:
            k.launches = 0
        # -- the main path: the sharded loop --------------------------------
        out, rec, wall = _srv_loop(model, reqs, dev, paged, ref, SRV_TP_RTOL, SRV_TP_ATOL)
        launches = _srv_counts(kernels)
        # --------------------------------------------------------------------
        steps, prefills = len(rec.decode_s), len(rec.prefill_s)
        want = {k.__name__: 0 for k in kernels}
        want[k3.__name__] = per_fwd * (steps + prefills)
        want[(k6 if paged else k4a).__name__] = depth * steps
        if launches != want:
            fail(f"phase 22 llama tp={tp} paged={paged}: launches {launches}, expected {want}")
        key = "paged" if paged else "dense"
        res[key] = dict(_srv_stats(rec, wall, tokens), launches=launches,
                        **rec.verdict(f"phase 22 llama tp={tp} {key}"))
        if ref is not None:
            res[key]["tokens_equal"] = out == refs[paged][0]
    for k in kernels:
        k.launches = 0
    # -- the main path: generate on one prompt ------------------------------------
    gen = model.generate(prompt, SRV_NEW).tolist()
    torch.cuda.synchronize()
    launches = _srv_counts(kernels)
    # --------------------------------------------------------------------------
    want = {k.__name__: 0 for k in kernels}
    want[k3.__name__], want[k5a.__name__] = per_fwd * SRV_NEW, depth * (SRV_NEW - 1)
    if launches != want:
        fail(f"phase 22 llama tp={tp} generate: launches {launches}, expected {want}")
    res["generate"] = dict(launches=launches)
    if "generate" in refs:
        res["generate"]["tokens_equal"] = gen == refs["generate"]
        n = next((i for i, (a, b) in enumerate(zip(gen, refs["generate"])) if a != b), None)
        res["generate"]["first_difference"] = n
    del model
    torch.cuda.empty_cache()
    return res


def _srv_llama_world1(dev, seed):
    """A world of 1 over NCCL: the W4 Llama's dense loop through a (1, 1)
    mesh equals the unsharded loop bit for bit."""
    from micronet_tpu_torch.parallel import make_mesh

    res = _srv_llama(dev, seed, make_mesh(1, 1), SRV_DEPTH_SHARED)
    for key in ("dense", "paged"):
        r = res[key]
        if r["max_abs_diff"] != 0.0 or not r["tokens_equal"]:
            fail(f"phase 22 world of 1 ({key}): max|diff| {r['max_abs_diff']}, tokens equal "
                 f"{r['tokens_equal']}")
    return res


def _srv_decoder(dev, seed, mesh):
    """The W4 TinyDecoder (phase 18's dense form) tensor-parallel behind
    ``ServeLoop(4)`` against the unsharded loop on rank 0: logits within
    1e-4, tokens up to a near tie, K3 and K5a counted."""
    import torch.distributed as dist

    from micronet_tpu_torch.ops import decode_attention as da
    from micronet_tpu_torch.ops import int4_matmul as im
    from micronet_tpu_torch.parallel import shard_state
    from micronet_tpu_torch.parallel.sharding import axis_size
    from micronet_tpu_torch.serve import Request

    model = _decoder_pair(0, 1, dev, seed)[1]
    rng = np.random.default_rng(seed + 18)
    reqs = [Request(i, rng.integers(0, DECODER_KW["vocab"], p).tolist(), new)
            for i, (p, new, _) in enumerate(DECODER_REQUESTS)]
    tokens = sum(r.max_new_tokens - 1 for r in reqs)
    ref, res = None, dict(tp=axis_size(mesh, "model"))
    if dist.get_rank() == 0:
        _, ref, wall = _srv_loop(model, reqs, dev, False, slots=DECODER_SLOTS,
                                 rec_cls=_TimedDecoder)
        res["one_card"] = _srv_stats(ref, wall, tokens)
    dist.barrier()
    shard_state(model, mesh)
    kernels = (im.int4_matmul_grouped_hl8, da.decode_attend_q8kv)
    for k in kernels:
        k.launches = 0
    # -- the main path: the sharded TinyDecoder loop ------------------------------
    _, rec, wall = _srv_loop(model, reqs, dev, False, ref, SRV_TP_RTOL, SRV_TP_ATOL,
                             slots=DECODER_SLOTS, rec_cls=_TimedDecoder)
    launches = _srv_counts(kernels)
    # --------------------------------------------------------------------------
    depth = DECODER_KW["depth"]
    steps, prefills = len(rec.decode_s), len(rec.prefill_s)
    want = {kernels[0].__name__: 6 * depth * (prefills + DECODER_SLOTS * steps),
            kernels[1].__name__: depth * DECODER_SLOTS * steps}
    if launches != want:
        fail(f"phase 22 decoder tp: launches {launches}, expected {want}")
    res.update(_srv_stats(rec, wall, tokens), launches=launches,
               **rec.verdict("phase 22 decoder tp"))
    return res


def _greedy_logits(model, prompt, steps):
    """Prefill ``prompt``, then ``steps`` T = 1 forwards of the greedy
    tokens: (logits of each step's last position, tokens, caches)."""
    logits, caches = model.forward(prompt, model.init_cache(), 0)
    outs, toks = [logits[-1]], []
    pos = int(prompt.shape[0])
    for _ in range(steps):
        tok = int(outs[-1].argmax())
        toks.append(tok)
        logits, caches = model.forward(torch.tensor([tok], device=prompt.device), caches, pos)
        pos += 1
        outs.append(logits[-1])
    return torch.stack(outs), toks, caches


def _first_tie(a, b, atol):
    """Rows of ``a`` against the reference rows ``b`` up to the first whose
    argmax differs: (that row or None, max|diff| up to it, whether every
    row before lies within ``atol`` and the reference's top-2 gap there
    within twice it)."""
    worst = 0.0
    for i in range(a.shape[0]):
        diff, outside, tie = _compare_row(a[i], b[i], atol, 0.0)
        worst = max(worst, diff)
        if outside or tie is not None:
            return i, worst, not outside and tie["ref_gap"] <= tie["tie_bound"]
    return None, worst, True


def _srv_ep(dev, seed, group_size):
    """The MoE TinyDecoder (8 int8 experts, top-1) with ``use_ep`` over the
    ``expert`` axis against the same model dense: prefill and greedy decode
    logits within 2e-5, tokens up to a near tie; then ``moe_apply_ep``
    forward and backward against ``moe_apply`` (1e-5) and top-2
    ``moe_apply_ep_a2a`` against ``moe_apply`` on each token shard."""
    import dataclasses

    from micronet_tpu_torch.parallel import (init_moe, moe_apply, moe_apply_ep,
                                             moe_apply_ep_a2a, quantize_moe)
    from micronet_tpu_torch.parallel.sharding import axis_mesh

    mesh = axis_mesh("expert", group_size)
    dense = _decoder_pair(8, 1, dev, seed)[1]
    ep = _decoder_pair(8, 1, dev, seed)[1]
    for blk in ep.blocks:
        blk.moe.use_ep(mesh)
    prompt = torch.tensor(DECODER_PROMPT, device=dev)
    ld, toks, _ = _greedy_logits(dense, prompt, SRV_EP_STEPS)
    le, toks_e, _ = _greedy_logits(ep, prompt, SRV_EP_STEPS)
    where, diff, tie = _first_tie(le, ld, SRV_EP_ATOL)
    if not tie:
        fail(f"phase 22 EP decoder: row {where} max|diff| {diff:.3e} against dense")
    res = dict(experts_per_rank=ep.blocks[0].moe.w_up.shape[0], max_abs_diff=diff,
               first_tie_position=where, tokens_equal=toks == toks_e)

    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    dim, mlp = DECODER_KW["dim"], DECODER_KW["mlp_dim"]
    p = init_moe(dim, mlp, 8, device=dev, generator=gen)
    x = torch.randn((64 * group_size, dim), device=dev, generator=gen)
    grads = {}
    for label, fn in (("ep", lambda q, xi: moe_apply_ep(q, xi, mesh, capacity_factor=2.0)),
                      ("dense", lambda q, xi: moe_apply(q, xi, 2.0))):
        q = dataclasses.replace(p, **{n: getattr(p, n).clone().requires_grad_()
                                      for n in ("router", "w_up", "w_down")})
        xi = x.clone().requires_grad_()
        loss = torch.mean(fn(q, xi) ** 2)
        loss.backward()
        grads[label] = [loss.detach(), q.router.grad, q.w_up.grad, q.w_down.grad, xi.grad]
    worst = 0.0
    for a, b in zip(grads["ep"], grads["dense"]):
        err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
    if not worst <= SRV_RTOL:
        fail(f"phase 22 moe_apply_ep: value or gradient {worst:.3e} x max|.| from dense")
    res["moe_apply_ep_rel_diff"] = worst
    qp = quantize_moe(p)
    with torch.no_grad():
        got = moe_apply_ep_a2a(qp, x, mesh, capacity_factor=2.0, top_k=2)
        ref = torch.cat([moe_apply(qp, xs, 2.0, top_k=2) for xs in x.chunk(group_size)])
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    if not err <= SRV_RTOL:
        fail(f"phase 22 moe_apply_ep_a2a top-2: {err:.3e} x max|.| from moe_apply by shard")
    res["a2a_top2_rel_diff"] = err
    return res


def _median_ms(fn, barrier=False):
    """Median wall ms of ``SRV_TIMED`` synchronised calls of ``fn`` (each
    after a barrier of the world where ``barrier``)."""
    import torch.distributed as dist

    ms = []
    for _ in range(SRV_TIMED):
        if barrier:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return sorted(ms)[len(ms) // 2]


def _srv_sp_exact(dev, mesh, group_size):
    """The dry run's SP check at its configuration (``__graft_entry__.py:
    268-290``): the W4 TinyDecoder of dim 16, 2 heads, depth 1, group 8,
    on 2 x S tokens, ``prefill_sp`` against ``forward`` within 2e-5 and
    the int8 codes equal."""
    from micronet_tpu_torch.models.tiny_decoder import TinyDecoder, quantize_decoder

    dec = quantize_decoder(TinyDecoder(vocab=32, dim=16, heads=2, depth=1, mlp_dim=32,
                                       max_seq=2 * group_size + 2, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(0)),
                           group=8)
    toks = torch.arange(2 * group_size, device=dev) % 32
    ls, cs = dec.prefill_sp(toks, dec.init_cache(), mesh)
    ld, cd = dec.forward(toks, dec.init_cache(), 0)
    diff = (ls - ld).abs().max().item()
    if not diff <= SRV_SP_ATOL or not torch.equal(cs[0].k_codes, cd[0].k_codes):
        fail(f"phase 22 SP (the dry run's decoder): max|diff| {diff:.3e}, codes equal "
             f"{torch.equal(cs[0].k_codes, cd[0].k_codes)}")
    return diff


def _srv_sp_blocks(model, toks, mesh):
    """Each block of ``model`` fed the dense prefill's input to it: its
    cache from the SP prefill equals the dense one bit for bit, and ring
    attention over the dequantized rows equals ``attend`` on them within
    2e-5. Returns the largest attention difference."""
    from micronet_tpu_torch.parallel import ring_attention
    from micronet_tpu_torch.quant.kv_cache import append_kv, attend

    t = toks.shape[0]
    x = model.embed[toks] + model.pos[torch.arange(t, device=toks.device)]
    worst = 0.0
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            _, c_sp = blk.prefill_sp(x, model.init_cache()[i], mesh)
            y, c_d = blk(x, model.init_cache()[i], 0)
            if not all(torch.equal(getattr(c_sp, f), getattr(c_d, f))
                       for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length")):
                fail(f"phase 22 SP T={t}: block {i}'s cache differs from the dense prefill's")
            h = blk.norm1(x)
            q, k, v = blk._split(blk.wq(h)), blk._split(blk.wk(h)), blk._split(blk.wv(h))
            cache = append_kv(model.init_cache()[i], k, v)
            ref = attend(cache, q, causal_offset=0).transpose(0, 1)
            ring = ring_attention(q.transpose(0, 1).to(torch.float32),
                                  cache.dequant_k()[:, :t].transpose(0, 1),
                                  cache.dequant_v()[:, :t].transpose(0, 1), mesh)
            worst = max(worst, (ring - ref).abs().max().item())
            x = y
    if not worst <= SRV_SP_ATOL:
        fail(f"phase 22 SP T={t}: ring attention {worst:.3e} from attend on the same rows")
    return worst


def _srv_sp(dev, seed, group_size):
    """Sequence parallelism over the ``seq`` axis: the dry run's SP check at
    its configuration (:func:`_srv_sp_exact`); ``prefill_sp`` of phase
    18's W4 TinyDecoder at each prompt of ``SRV_SP_PROMPTS`` (the zigzag
    schedule), block by block (:func:`_srv_sp_blocks`: caches bit for bit,
    attention 2e-5), then whole: its ms beside the dense prefill's, the
    logits within ``DECODER_CARD_CPU_TOL`` of the dense prefill's (each
    block's W4 matmuls round their input to bf16, so an f32-level
    difference of the two attentions can move a term by 2^-8: the cause of
    that bound), the first layer's cache bit for bit; from the shorter
    prompt's caches, 16 decode steps of the dense path's greedy tokens,
    within the same bound; ring attention forward and backward against the
    dense oracle (1e-5)."""
    from micronet_tpu_torch.parallel import attention_reference, ring_attention
    from micronet_tpu_torch.parallel.sharding import axis_mesh

    mesh = axis_mesh("seq", group_size)
    res = dict(dry_run_max_abs=_srv_sp_exact(dev, mesh, group_size))
    model = _decoder_pair(0, 1, dev, seed)[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    for n in SRV_SP_PROMPTS:
        toks = torch.randint(0, DECODER_KW["vocab"], (n,), device=dev, generator=gen)
        r = dict(block_attention_max_abs=_srv_sp_blocks(model, toks, mesh))
        times = {}
        with torch.no_grad():
            for label, fn in (("sp", lambda: model.prefill_sp(toks, model.init_cache(), mesh)),
                              ("dense", lambda: model.forward(toks, model.init_cache(), 0))):
                times[label] = (fn(), _median_ms(fn))
        (ls, cs), (ld, cd) = times["sp"][0], times["dense"][0]
        bound = DECODER_CARD_CPU_TOL * max(1.0, ld.abs().max().item())
        diff = (ls - ld).abs().max().item()
        codes_differ = [int((a.k_codes != b.k_codes).sum() + (a.v_codes != b.v_codes).sum())
                        for a, b in zip(cs, cd)]
        if not diff <= bound or codes_differ[0]:
            fail(f"phase 22 SP prefill T={n}: max|diff| {diff:.3e} (bound {bound:.1e}), codes "
                 f"differing by layer {codes_differ}")
        r.update(max_abs_diff=diff, codes_differing_by_layer=codes_differ,
                 sp_ms=times["sp"][1], dense_ms=times["dense"][1])
        if n + SRV_SP_STEPS <= DECODER_KW["max_seq"]:
            with torch.no_grad():
                _, toks_d, _ = _greedy_logits(model, toks, SRV_SP_STEPS)
                steps = {}
                for label, caches in (("sp", cs), ("dense", cd)):
                    outs = []
                    for i, tok in enumerate(toks_d):
                        logits, caches = model.forward(torch.tensor([tok], device=dev), caches,
                                                       n + i)
                        outs.append(logits[-1])
                    steps[label] = torch.stack(outs)
            where, sdiff, tie = _first_tie(steps["sp"], steps["dense"], bound)
            if not tie:
                fail(f"phase 22 SP T={n}: decode step {where} from the SP caches max|diff| "
                     f"{sdiff:.3e} from the dense caches'")
            r.update(decode_steps=SRV_SP_STEPS, decode_max_abs_diff=sdiff,
                     decode_first_tie=where)
        res[f"T{n}"] = r
    q, k, v = (torch.randn((64, DECODER_KW["heads"], DECODER_KW["dim"] // DECODER_KW["heads"]),
                           device=dev, generator=gen) for _ in range(3))
    out = {}
    for label, fn in (("ring", lambda a: ring_attention(a, k, v, mesh, causal=True)),
                      ("dense", lambda a: attention_reference(a, k, v, causal=True))):
        a = q.clone().requires_grad_()
        loss = torch.mean(fn(a) ** 2)
        loss.backward()
        out[label] = (loss.detach(), a.grad)
    rel = max(abs(out["ring"][0].item() - out["dense"][0].item()) / out["dense"][0].item(),
              ((out["ring"][1] - out["dense"][1]).abs().max()
               / out["dense"][1].abs().max()).item())
    if not rel <= SRV_RTOL:
        fail(f"phase 22 ring attention: {rel:.3e} x max|.| from the dense oracle")
    res["ring_rel_diff"] = rel
    return res


def _srv_pipeline(dev, seed, group_size):
    """``pipeline_apply_stateful`` over ``group_size`` stages of NIN's
    seventh block (IAO W8A8 ``bn_fuse``, training mode), one a rank, 2 x S
    microbatches of 64 on 8x8 maps, forward and backward, against the
    sequential fold on rank 0 (loss, every gradient, every observer and BN
    buffer); img/s of both and the measured bubble share."""
    import torch.distributed as dist

    from micronet_tpu_torch.graft_entry import _stage_fn
    from micronet_tpu_torch.models.nin import ConvBNReLU
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.parallel import pipeline_apply_stateful, stack_stage_params
    from micronet_tpu_torch.parallel.sharding import axis_mesh
    from micronet_tpu_torch.quant.config import QuantConfig

    s = group_size
    mesh = axis_mesh("stage", s)
    rank = dist.get_rank(mesh.get_group("stage"))
    c, n_micro = SRV_PIPE_C, 2 * s

    def stage(i):
        return train_mode(prepare(ConvBNReLU(c, c, 3, padding=1, device=dev,
                                             generator=torch.Generator(device=dev)
                                             .manual_seed(seed + i)),
                                  QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), method="iao",
                                  device=dev))

    stages = [stage(i) for i in range(s)]
    plist = [{k: v.detach() for k, v in m.named_parameters()} for m in stages]
    rlist = [{k: v.detach() for k, v in m.named_buffers()} for m in stages]
    fn = _stage_fn(stages[0])
    x = torch.randn((n_micro, SRV_PIPE_MICRO, c, SRV_PIPE_SIZE, SRV_PIPE_SIZE), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed + 25))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def pipe():
        p = {k: v[rank:rank + 1].clone().requires_grad_()
             for k, v in stack_stage_params(plist).items()}
        st = {k: v[rank:rank + 1] for k, v in stack_stage_params(rlist).items()}
        out, new = pipeline_apply_stateful(fn, p, st, x, mesh)
        loss = torch.mean(out ** 2)
        loss.backward()
        return loss.detach(), {k: v.grad[0] for k, v in p.items()}, {k: v[0] for k, v in
                                                                      new.items()}

    def fold():
        ps = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in plist]
        rests = [{k: v.clone() for k, v in r.items()} for r in rlist]
        outs = []
        for mb in range(n_micro):
            h = x[mb]
            for i in range(s):
                h, rests[i] = fn(ps[i], rests[i], h)
            outs.append(h)
        loss = torch.mean(torch.stack(outs) ** 2)
        loss.backward()
        return loss.detach(), [{k: v.grad for k, v in p.items()} for p in ps], rests

    try:
        loss, grads, state = pipe()
        pipe_ms = _median_ms(pipe, barrier=True)
        res = dict(stages=s, microbatches=n_micro, micro_batch=SRV_PIPE_MICRO)
        if rank == 0:
            f_loss, f_grads, f_state = fold()
            fold_ms = _median_ms(fold)
        dist.barrier()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # each rank's stage against the fold's: rank 0 holds the fold, so the
    # ranks' gradients and state come to it
    from micronet_tpu_torch.parallel.distributed import _gather_parts

    group = mesh.get_group("stage")
    g_all = {k: _gather_parts(v, group) for k, v in grads.items()}
    s_all = {k: _gather_parts(v, group) for k, v in state.items()}
    if rank == 0:
        rel = abs(loss.item() - f_loss.item()) / abs(f_loss.item())
        g_worst = max(((g_all[k][i] - f_grads[i][k]).abs().max()
                       / f_grads[i][k].abs().max().clamp_min(1e-30)).item()
                      for k in g_all for i in range(s))
        s_worst = max(((s_all[k][i].float() - f_state[i][k].float()).abs().max()
                       / f_state[i][k].float().abs().max().clamp_min(1e-30)).item()
                      for k in s_all for i in range(s))
        if not (rel <= SRV_PIPE_RTOL and g_worst <= SRV_PIPE_GRAD_RTOL
                and s_worst <= SRV_PIPE_STATE_RTOL):
            fail(f"phase 22 pipeline: loss rel {rel:.3e}, gradients {g_worst:.3e}, state "
                 f"{s_worst:.3e} x max|.| from the fold")
        images = n_micro * SRV_PIPE_MICRO
        res.update(loss_rel_diff=rel, grad_rel_diff=g_worst, state_rel_diff=s_worst,
                   pipe_ms=pipe_ms, fold_ms=fold_ms, pipe_img_s=images / pipe_ms * 1e3,
                   fold_img_s=images / fold_ms * 1e3,
                   bubble_predicted=(s - 1) / (n_micro + s - 1),
                   bubble_measured=1.0 - fold_ms / (s * pipe_ms))
    return res


def _srv_rank(rank, world, port, shared: Path, seed, gloo):
    """One rank of phase 22: with NCCL on one card the world of 1
    (:func:`_srv_llama_world1`); otherwise, over ``world`` ranks, the W4
    Llama at tp = world (and, on four cards, at tp = 2 on a (2, 2) mesh),
    the TinyDecoder at tp = world, EP, SP and the pipeline at world."""
    import torch.distributed as dist

    from micronet_tpu_torch.models.llama import llama3_8b
    from micronet_tpu_torch.parallel import make_mesh

    dev = _par_init(rank, world, port, gloo)
    res = dict(world=world, backend=dist.get_backend())
    if world == 1:
        res["llama_world1"] = _srv_llama_world1(dev, seed)
    else:
        depth = SRV_DEPTH_SHARED if gloo else llama3_8b().n_layers
        res[f"llama_tp{world}"] = _srv_llama(dev, seed, make_mesh(1, world), depth)
        if world == 4:
            res["llama_tp2"] = _srv_llama(dev, seed, make_mesh(2, 2), depth)
        res["decoder_tp"] = _srv_decoder(dev, seed, make_mesh(1, world))
        res["ep"] = _srv_ep(dev, seed, world)
        res["sp"] = _srv_sp(dev, seed, world)
        res["pipeline"] = _srv_pipeline(dev, seed, world)
    if rank == 0:
        (shared / f"serving_{'gloo' if gloo else 'nccl'}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


SRV_K3_TPS = (2, 4)


def k3_tp_times(dev, gen, report) -> dict:
    """K3 at the column slices one rank of a tensor-parallel 8B decode step
    runs (each of ``K3_SHAPES`` at N / tp, M = 8, ``split_cols`` the whole
    N, as ``shard_state`` sets it), against its twin within K3's tolerance;
    a step's 129 calls' ms (events, weights cold in L2) beside the twin's,
    ``torch.matmul``'s on the dequantized bf16 slice and the bytes bound,
    for each tp of ``SRV_K3_TPS``."""
    from micronet_tpu_torch.ops import int4_matmul as im

    res = {}
    for tp in SRV_K3_TPS:
        step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
        for (k, n), per_step in K3_SHAPES:
            weights, w_bf16 = _k3_weights(k, n // tp, dev, gen)
            x = torch.randn((8, k), device=dev, generator=gen)

            def sliced(xx, packed, gs, n=n):
                return im.int4_matmul_grouped_hl8(xx, packed, gs, split_cols=n)

            out = sliced(x, *weights[0])
            ref = im.int4_matmul_grouped_hl8_ref(x, *weights[0])
            err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
            if not err <= K3_REL_TOL * scale:
                fail(f"K3 tp={tp} K={k} N={n // tp}: max|err| {err:.3e} > {K3_REL_TOL} * "
                     f"{scale:.3e}")
            args, lib_args, iters = _k3_calls(8, x, weights, w_bf16)
            step["ms"] += per_step * time_ms(sliced, args, iters)
            step["plain_ms"] += per_step * time_ms(im.int4_matmul_grouped_hl8_ref, args, 5, 1)
            step["library_ms"] += per_step * time_ms(torch.matmul, lib_args, iters)
            step["bound_ms"] += per_step * _k3_bound(8, k, n // tp)[0]
            step["max_abs_err"] = max(step["max_abs_err"], err)
            del weights, w_bf16, args, lib_args
            torch.cuda.empty_cache()
        res[f"tp{tp}"] = step
        log(f"K3 tp={tp}, one rank's decode step at M=8 (129 calls at N / {tp}): "
            f"{step['ms']:.4f} ms, plain {step['plain_ms']:.3f} ms, torch.matmul bf16 "
            f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms (bytes)")
    report["k3_tp"] = res
    return res


def serving_parallel(dev, seed, shared: Path, card: str, report) -> dict:
    """Phase 22: tensor-parallel W4 serving, expert, sequence and pipeline
    parallelism (each check above). Returns the kernels' launch counts of
    the phase's main paths (rank 0's)."""
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    _spawn(_srv_rank, world, shared, seed, False)
    nccl = json.loads((shared / "serving_nccl.json").read_text())
    t1 = time.perf_counter()
    runs = dict(nccl=nccl, nccl_seconds=t1 - t0)
    if world == 1:
        _spawn(_srv_rank, 2, shared, seed, True)
        runs["gloo"] = json.loads((shared / "serving_gloo.json").read_text())
        runs["gloo_seconds"] = time.perf_counter() - t1
    report["serving_parallel"] = dict(card=card, **runs)
    main = runs.get("gloo", nccl)
    w = main["world"]
    w1 = nccl.get("llama_world1")
    if w1 is not None:
        log(f"serving parallel (NCCL, world 1): the W4 Llama ({w1['depth']} blocks) through "
            f"make_mesh(1, 1) equals the unsharded loop bit for bit, dense and paged "
            f"({runs['nccl_seconds']:.1f} s)")
    counts = {}
    for key in [k for k in main if k.startswith("llama_tp")]:
        r = main[key]
        for loop in ("dense", "paged"):
            x = r[loop]
            log(json.dumps({"phase": 22, "what": f"llama {key} {loop}", "card": card,
                            "backend": main["backend"], "depth": r["depth"], **{
                                k: x[k] for k in ("decode_tok_s", "step_ms_median",
                                                  "step_ms_max", "prefill_ms", "max_abs_diff",
                                                  "first_tie_position", "diverged_requests")},
                            "one_card": {k: r["one_card_paged" if loop == "paged" else
                                              "one_card"][k]
                                         for k in ("decode_tok_s", "step_ms_median",
                                                   "step_ms_max", "prefill_ms")},
                            "launches": x["launches"]}))
        counts[key] = {"dense": r["dense"]["launches"], "paged": r["paged"]["launches"],
                       "generate": r["generate"]["launches"]}
    d = main["decoder_tp"]
    counts["decoder_tp"] = d["launches"]
    log(json.dumps({"phase": 22, "what": f"decoder tp={d['tp']}", "card": card, **{
        k: d[k] for k in ("decode_tok_s", "step_ms_median", "step_ms_max", "max_abs_diff",
                          "first_tie_position")},
        "one_card_tok_s": d["one_card"]["decode_tok_s"], "launches": d["launches"]}))
    e, s, p = main["ep"], main["sp"], main["pipeline"]
    log(json.dumps({"phase": 22, "what": f"ep={w} sp={w} pp={w}", "card": card,
                    "ep_decoder_max_abs": e["max_abs_diff"],
                    "ep_first_tie": e["first_tie_position"],
                    "moe_apply_ep_rel": e["moe_apply_ep_rel_diff"],
                    "a2a_top2_rel": e["a2a_top2_rel_diff"],
                    **{f"sp_T{n}_ms": s[f"T{n}"]["sp_ms"] for n in SRV_SP_PROMPTS},
                    **{f"dense_T{n}_ms": s[f"T{n}"]["dense_ms"] for n in SRV_SP_PROMPTS},
                    "sp_max_abs": max(s[f"T{n}"]["max_abs_diff"] for n in SRV_SP_PROMPTS),
                    "ring_rel": s["ring_rel_diff"], "pipe_img_s": p["pipe_img_s"],
                    "fold_img_s": p["fold_img_s"], "bubble_predicted": p["bubble_predicted"],
                    "bubble_measured": p["bubble_measured"],
                    "pipe_loss_rel": p["loss_rel_diff"], "pipe_grad_rel": p["grad_rel_diff"]}))
    return counts


# ---------------------------------------------------------------- phase 23


LENET_BATCH = NIN_BATCH  # LeNet's engine at NIN-GC's engine batch
# ResNet-50's engine against its fake-quant model: FQ_TOL's cause over 53
# quantized convs instead of 20. The JAX package's own W8A8 ResNet-50 engine
# sits 0.31 from its fake-quant model (max|logit| 1.2, one argmax of 8
# off; the port's CPU engine 0.24 from the same weights and calibration:
# tests/_torch_resnet50_gap.py), and its ResNet-50 test
# (tests/test_resnet_quant.py:57-90) holds only the argmax
RESNET50_FQ_TOL = 0.4


def bottleneck_lenet_engines(dev, seed, report, profile_dir=None, later=None) -> dict:
    """Phase 23: full-width ``resnet50()`` (BottleNeck blocks) at batch 512
    and ``LeNet()`` at batch 1,024 through phase 9's engine path, W8A8 with
    fused BN, phase 9's cuts. K1 must launch once per forward for each
    symmetric ``IntLinear`` the engine holds (ResNet-50's fc at K = 2,048,
    LeNet's three Linears) and nothing else may launch. ResNet-50's engine
    is held to its fake-quant model within ``RESNET50_FQ_TOL``, LeNet's
    within ``FQ_TOL``. Returns K1's launches by engine."""
    from micronet_tpu_torch.infer.engine import IntLinear
    from micronet_tpu_torch.models.lenet import LeNet
    from micronet_tpu_torch.models.resnet import resnet50
    from micronet_tpu_torch.quant.config import QuantConfig

    out = {}
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True, **EXACT)
    for name, build, batch, fq_tol in (("resnet50_w8a8", resnet50, RESNET_BATCH, RESNET50_FQ_TOL),
                                       ("lenet_w8a8", LeNet, LENET_BATCH, FQ_TOL)):
        keep = {}
        torch.cuda.reset_peak_memory_stats()
        launches, forwards = engine_path(name, build, cfg, batch, dev, seed, report,
                                         profile_dir, later, keep=keep, fq_tol=fq_tol)
        k1_layers = [(n, tuple(m.w_q.shape)) for n, m in keep["engine"].named_modules()
                     if isinstance(m, IntLinear) and m.symmetric and m.w_symmetric]
        want = {k.__name__: 0 for k in _all_kernels()}
        want["int8_matmul_dequant"] = len(k1_layers) * forwards
        if launches != want:
            fail(f"{name}: launch counts {launches}, expected {want} (K1 layers {k1_layers})")
        report[name]["k1_layers"] = k1_layers
        log(f"{name}: K1 layers (K, N) {k1_layers}, {launches['int8_matmul_dequant']} "
            f"launches over {forwards} forwards; peak {report[name]['peak_gb']:.2f} GB")
        out[name] = launches["int8_matmul_dequant"]
        del keep
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 24


PREFILL_CHUNK = 64
# (temperature, top_k, top_p) of phase 24's sampled requests, request i taking
# i % 4: greedy, top-k, top-p, both
SAMPLING = [(0.0, 0, 1.0), (0.8, 50, 1.0), (1.0, 0, 0.9), (0.7, 40, 0.95)]
# the loop past 128 slots: every decode step runs K3 in regime B
SLOTS_B, SLOTS_B_PROMPTS, SLOTS_B_NEW, SLOTS_B_FORCED = K3_SLOTS_B, (16, 64), 8, 8
# K3's two regimes through the whole model: the 136-slot loop's decode
# steps and the whole prefill of a prompt over 128 tokens (regime B)
# against generate's steps and 64-row chunks (regime A). K3's own gap
# (K3_REL_TOL: f32 sums in another order) reaches activations that are
# rounded to bf16 before the next W4 matmul, and this random-weight model
# amplifies a 1-ulp change of one block's input about 1e4-fold by the
# logits (an RMSNorm output an ulp off at block 17 gave 5e-3 at the
# lm_head on an H100). Measured 6.6e-3 (chunked prefill) and 3.9e-3 (136
# slots) of the largest logit: the whole-model bound, not K3's.
REGIME_REL_TOL = MODEL_REL_TOL
# chunked prefill of prompts up to 128 tokens runs regime A either way,
# and the prefill attention gives a row the same bits at M = 64 as at the
# whole prompt (measured on an H100): bit for bit
CHUNK_SAME_REL_TOL = 0.0


class _StepLog(_Timed):
    """Model proxy for one ``ServeLoop`` (:meth:`attach`): times every
    prefill and decode step, as :class:`_Timed`, keeps by request id the
    logits each token of the requests in ``rids`` (None: every request)
    was drawn from (the prefill's last row, then the request's row of each
    decode step), and feeds ``force[rid][i]`` in place of the request's
    i-th token (teacher forcing; the loop's own tokens are still its
    argmax or draw)."""

    def __init__(self, model, rids=None, force=None):
        super().__init__(model)
        self.rids, self.force, self.logits = rids, force or {}, {}
        self.loop, self.prefills_before_decode = None, None

    def _keeps(self, rid):
        return self.rids is None or rid in self.rids

    def attach(self, loop):
        self.loop = loop
        admit, prefill = loop._admit, loop._prefill
        last = []

        def prefill_logged(prompt):
            out = prefill(prompt)
            last.append(out[0])
            return out

        def admit_logged(slot, req):
            last.clear()
            ok = admit(slot, req)
            if ok and self._keeps(req.rid):
                self.logits[req.rid] = [last[0].float().clone()]
            return ok

        loop._prefill, loop._admit = prefill_logged, admit_logged
        return loop

    def _step(self, fn, tokens, *rest):
        reqs = list(self.loop.slot_req)
        if self.prefills_before_decode is None:
            self.prefills_before_decode = len(self.prefill_s)
        if self.force:
            tokens = tokens.clone()
            for s, r in enumerate(reqs):
                if r is not None and r.rid in self.force:
                    tokens[s, 0] = self.force[r.rid][len(r.output) - 1]
        logits, caches = self._time(fn, self.decode_s, tokens, *rest)
        for s, r in enumerate(reqs):
            if r is not None and self._keeps(r.rid):
                self.logits[r.rid].append(logits[s, 0].float().clone())
        return logits, caches

    def decode_batch(self, tokens, caches, offsets):
        return self._step(self._m.decode_batch, tokens, caches, offsets)

    def decode_batch_paged(self, tokens, caches, offsets, active):
        return self._step(self._m.decode_batch_paged, tokens, caches, offsets, active)


def outside_kept_set(reqs, outputs, step_log):
    """The tokens in ``outputs`` (request id -> tokens) of ``reqs`` that lie
    outside the set ``serve.sampling.kept_tokens`` gives, with the
    request's settings, on the logits ``step_log`` kept for them:
    ([(request id, index, token)], how many tokens were checked)."""
    from micronet_tpu_torch.serve.sampling import kept_tokens

    bad, checked = [], 0
    for r in reqs:
        rows, out = step_log.logits[r.rid], outputs[r.rid]
        if len(rows) != len(out):
            fail(f"request {r.rid}: {len(out)} tokens but {len(rows)} logged rows")
        for i, (row, tok) in enumerate(zip(rows, out)):
            checked += 1
            if not bool(kept_tokens(row, r.temperature, r.top_k, r.top_p)[tok]):
                bad.append((r.rid, i, tok))
    return bad, checked


def held_to(what, rows, ref_rows, rel_tol, forced):
    """Greedy logits ``rows`` against the reference's ``ref_rows``, position
    by position, each within ``rel_tol`` x max|reference row| (fatal
    otherwise). Within it, a token (argmax) can differ from the
    reference's only where the reference's top-two margin is at most twice
    that bound: a near tie. Without ``forced`` (teacher forcing) the inputs
    differ after the first such token, and the comparison stops there.
    Returns (the positions whose tokens differ, the largest |difference| /
    max|reference row|)."""
    differ, worst = [], 0.0
    for i, (a, b) in enumerate(zip(rows, ref_rows)):
        scale = b.abs().max().item()
        diff, outside, tie = _compare_row(a, b, rel_tol * scale, 0.0)
        worst = max(worst, diff / scale)
        if outside or not torch.isfinite(a).all():
            fail(f"{what}: logits at position {i} differ by {diff:.3e} "
                 f"(tol {rel_tol} x {scale:.3e})")
        if tie is not None:
            differ.append(i)
            if not forced:
                break
    return differ, worst


def _loop_with_log(model, slots, dev, reqs, rids=None, force=None, **loop_kw):
    """``reqs`` through ``ServeLoop(slots, **loop_kw)`` over a
    :class:`_StepLog` (:func:`_serve_all`; a paged loop must give every
    page back): (outputs by request id, the log, wall s)."""
    from micronet_tpu_torch.serve import ServeLoop

    step_log = _StepLog(model, rids, force)
    loop = step_log.attach(ServeLoop(step_log, slots, device=dev, **loop_kw))
    outputs, _, wall = _serve_all(loop, reqs)
    if loop_kw.get("paged"):
        _check_pages_back(loop, loop.num_pages - 1)
    return outputs, step_log, wall


def _want(kernels, **nonzero):
    want = {k.__name__: 0 for k in kernels}
    want.update(nonzero)
    return want


def chunked_prefill(model, reqs, served, dev) -> dict:
    """Phase 5's requests through ``ServeLoop(8, prefill_chunk=64)``, dense
    then paged (page 16), against the unchunked dense loop (run again here
    with its logits kept; its tokens must equal phase 5's), position by
    position up to the first token that differs (:func:`held_to`). Prompts
    of at most 128 tokens prefill in K3's regime A either way: their logits
    are held to ``CHUNK_SAME_REL_TOL`` (bit for bit, so equal tokens).
    Longer prompts prefill whole in regime B and in 64-row chunks in A:
    ``REGIME_REL_TOL``, a token differing only at a near tie. The paged
    loop's tokens equal the dense loop's. Exact launch counts: K3 129 a
    chunk forward and a decode step."""
    from micronet_tpu_torch.ops import int4_matmul as im

    per_fwd = 4 * model.cfg.n_layers + 1
    layers = model.cfg.n_layers
    long = {r.rid for r in reqs if len(r.prompt) > im._K3_DECODE_ROWS}
    ref, ref_log, _ = _loop_with_log(model, SLOTS, dev, reqs)
    if ref != served:
        fail(f"unchunked loop again: {ref}, phase 5 {served}")
    kernels = _all_kernels()
    res = dict(chunk=PREFILL_CHUNK, long_prompts=sorted(long))
    chunked = {}
    for mode, kw in (("dense", {}), ("paged", dict(paged=True, page_size=PAGE))):
        for k in kernels:
            k.launches = 0
        # -- the main path: the chunked loop ------------------------------
        done, step_log, wall = _loop_with_log(model, SLOTS, dev, reqs,
                                              prefill_chunk=PREFILL_CHUNK, **kw)
        launches = _srv_counts(kernels)
        # ------------------------------------------------------------------
        chunks = sum(-(-len(r.prompt) // PREFILL_CHUNK) for r in reqs)
        steps = len(step_log.decode_s)
        attn = "paged_decode_attend_cur" if mode == "paged" else "decode_attend_q8kv_cur"
        want = _want(kernels, int4_matmul_grouped_hl8=per_fwd * (chunks + steps),
                     **{attn: layers * steps})
        if len(step_log.prefill_s) != chunks or launches != want:
            fail(f"chunked {mode} loop: {len(step_log.prefill_s)} prefill forwards (expected "
                 f"{chunks}), launch counts {launches}, expected {want}")
        differ, worst = {}, {"short": 0.0, "long": 0.0}
        for r in reqs:
            kind = "long" if r.rid in long else "short"
            d, w = held_to(f"chunked {mode} loop, request {r.rid} ({len(r.prompt)} prompt "
                           f"tokens)", step_log.logits[r.rid], ref_log.logits[r.rid],
                           REGIME_REL_TOL if kind == "long" else CHUNK_SAME_REL_TOL,
                           forced=False)
            worst[kind] = max(worst[kind], w)
            if d:
                differ[r.rid] = d[0]
        chunked[mode] = done
        prefill_ms = sorted(1e3 * t for t in step_log.prefill_s)
        res[mode] = dict(launches=launches, chunk_forwards=chunks, decode_steps=steps,
                         wall_s=wall, chunk_ms_median=prefill_ms[len(prefill_ms) // 2],
                         prefill_s=sum(step_log.prefill_s), short_rel_max=worst["short"],
                         long_rel_max=worst["long"], long_token_differs_at=differ)
        log(f"chunked prefill ({mode}, chunk {PREFILL_CHUNK}): {chunks} chunk forwards "
            f"(median {res[mode]['chunk_ms_median']:.2f} ms), {steps} decode steps, wall "
            f"{wall:.2f} s; against the unchunked loop, logits within {worst['short']:.2e} x "
            f"max|logit| for prompts <= {im._K3_DECODE_ROWS} tokens (tol {CHUNK_SAME_REL_TOL}; "
            f"tokens equal), {worst['long']:.2e} for the {len(long)} longer ones (tol "
            f"{REGIME_REL_TOL}), tokens differing at a near tie: {differ or 'none'}; "
            f"launches {launches}")
        del step_log
    if chunked["paged"] != chunked["dense"]:
        fail("chunked prefill: the paged loop's tokens differ from the dense loop's")
    del ref_log
    torch.cuda.empty_cache()
    return res


def sampled_loops(model, reqs, dev, seed) -> dict:
    """Phase 5's prompts with mixed sampling settings (``SAMPLING``, each
    request its own seed) through ``ServeLoop(8)``: dense, dense again and
    paged (page 16). Each stream must equal ``generate_sampled`` with the
    same settings and seed on the card bit for bit (greedy ones
    ``generate``), the second run the first, and every token lie in the
    kept set ``kept_tokens`` gives on the logits it was drawn from. The
    card's generators draw other numbers than the CPU's from the same
    seed, so no token is compared across devices here (the CPU tests hold
    the same contracts on the CPU)."""
    from micronet_tpu_torch.serve import Request
    from micronet_tpu_torch.serve.sampling import generate_sampled

    per_fwd = 4 * model.cfg.n_layers + 1
    layers = model.cfg.n_layers
    sreqs = [Request(r.rid, list(r.prompt), NEW_TOKENS, temperature=t, top_k=k, top_p=p,
                     seed=1000 * seed + r.rid)
             for r, (t, k, p) in zip(reqs, SAMPLING * len(reqs))]
    kernels = _all_kernels()
    for k in kernels:
        k.launches = 0
    # -- the main path: three loops, then each request alone ---------------
    runs = {}
    for mode, kw in (("dense", {}), ("dense_again", {}), ("paged", dict(paged=True,
                                                                         page_size=PAGE))):
        done, step_log, wall = _loop_with_log(model, SLOTS, dev, sreqs, **kw)
        bad, checked = outside_kept_set(sreqs, done, step_log)
        if bad:
            fail(f"sampled {mode} loop: tokens outside their kept sets {bad[:8]}")
        runs[mode] = dict(out=done,
                          steps=len(step_log.decode_s), prefills=len(step_log.prefill_s),
                          checked=checked, wall_s=wall,
                          tok_per_s=len(sreqs) * (NEW_TOKENS - 1) / sum(step_log.decode_s))
        del step_log
    iso = {}
    for r in sreqs:
        prompt = torch.tensor(r.prompt, device=dev)
        toks = (model.generate(prompt, NEW_TOKENS) if r.temperature <= 0 else
                generate_sampled(model, prompt, NEW_TOKENS, temperature=r.temperature,
                                 top_k=r.top_k, top_p=r.top_p, seed=r.seed))
        iso[r.rid] = toks.tolist()
    torch.cuda.synchronize()
    launches = _srv_counts(kernels)
    # ----------------------------------------------------------------------
    steps = {m: v["steps"] for m, v in runs.items()}
    loops = sum(v["steps"] + v["prefills"] for v in runs.values())
    want = _want(kernels, int4_matmul_grouped_hl8=per_fwd * (loops + len(sreqs) * NEW_TOKENS),
                 decode_attend_q8kv_cur=layers * (steps["dense"] + steps["dense_again"]),
                 paged_decode_attend_cur=layers * steps["paged"],
                 decode_attend_q8kv=layers * len(sreqs) * (NEW_TOKENS - 1))
    if launches != want:
        fail(f"sampled loops: launch counts {launches}, expected {want}")
    for mode, v in runs.items():
        for r in sreqs:
            if v["out"][r.rid] != iso[r.rid]:
                fail(f"sampled {mode} loop: request {r.rid} (temperature {r.temperature}, "
                     f"top_k {r.top_k}, top_p {r.top_p}, seed {r.seed}) gave "
                     f"{v['out'][r.rid]}, alone {iso[r.rid]}")
    distinct = sum(len(set(t)) for t in iso.values()) / len(iso)
    res = dict(settings=SAMPLING, launches=launches,
               **{m: {k: v[k] for k in ("steps", "prefills", "checked", "wall_s", "tok_per_s")}
                  for m, v in runs.items()}, distinct_tokens_per_request=distinct)
    log(f"sampled loops: {len(sreqs)} requests ({SAMPLING}) each equal to its isolated "
        f"generate_sampled / generate run in the dense loop, again, and the paged loop; "
        f"{sum(v['checked'] for v in runs.values())} tokens inside their kept sets; "
        f"{distinct:.1f} distinct tokens a request; decode "
        f"{', '.join(f'{m} {v['tok_per_s']:.1f}' for m, v in runs.items())} tok/s; "
        f"launches {launches}")
    return res


def decode_past_128(model, dev, seed, card) -> dict:
    """``ServeLoop(136)``, dense, with 136 greedy requests (prompts of 16 to
    64 tokens, 8 new tokens), all admitted before the first decode step:
    every decode step runs K3 in regime B at M = 136 (counted at its GEMM
    call), K4a over 136 x 8 KV groups. Eight requests spread over the slots
    are fed ``generate``'s tokens (teacher forcing), and their logits are
    held to ``generate``'s position by position (``REGIME_REL_TOL``; a token
    may differ only at a near tie)."""
    from micronet_tpu_torch.ops import int4_matmul as im
    from micronet_tpu_torch.quant.kv_cache import kv_cache_bytes
    from micronet_tpu_torch.serve import Request

    cfg = model.cfg
    per_fwd = 4 * cfg.n_layers + 1
    if im._k3_regime(SLOTS_B, GROUP) != "B":
        fail(f"K3 at M={SLOTS_B}, group {GROUP} is in regime {im._k3_regime(SLOTS_B, GROUP)}")
    rng = np.random.default_rng(seed + 24)
    lens = rng.integers(SLOTS_B_PROMPTS[0], SLOTS_B_PROMPTS[1] + 1, SLOTS_B)
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, n)], SLOTS_B_NEW)
            for i, n in enumerate(lens)]
    forced = list(range(0, SLOTS_B, SLOTS_B // SLOTS_B_FORCED))[:SLOTS_B_FORCED]
    ref, force = {}, {}
    for rid in forced:
        rows, force[rid], _ = _greedy_logits(model, torch.tensor(reqs[rid].prompt, device=dev),
                                             SLOTS_B_NEW - 1)
        ref[rid] = rows.float()
    kernels = _all_kernels()
    gemm_call, gemm_calls = im._gemm_call, []

    def gemm_counted(x, *a, **kw):
        gemm_calls.append(int(x.shape[0]))
        return gemm_call(x, *a, **kw)

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    im._gemm_call = gemm_counted
    try:
        # -- the main path: 136 slots ------------------------------------
        done, step_log, wall = _loop_with_log(model, SLOTS_B, dev, reqs, rids=set(forced),
                                              force=force)
        launches = _srv_counts(kernels)
        # ------------------------------------------------------------------
    finally:
        im._gemm_call = gemm_call
    peak = torch.cuda.max_memory_allocated()
    steps = len(step_log.decode_s)
    want = _want(kernels, int4_matmul_grouped_hl8=per_fwd * (SLOTS_B + steps),
                 decode_attend_q8kv_cur=cfg.n_layers * steps)
    if (step_log.prefills_before_decode != SLOTS_B or steps != SLOTS_B_NEW - 1
            or launches != want or gemm_calls != [SLOTS_B] * (per_fwd * steps)):
        fail(f"{SLOTS_B} slots: {step_log.prefills_before_decode} admissions before the first "
             f"decode step, {steps} decode steps, launch counts {launches} (expected {want}), "
             f"regime-B calls at M {sorted(set(gemm_calls))} x {len(gemm_calls)} (expected "
             f"{per_fwd * steps} at {SLOTS_B})")
    for rid, out in done.items():
        if not all(0 <= t < cfg.vocab for t in out):
            fail(f"{SLOTS_B} slots: request {rid} gave {out}")
    differ, worst = {}, 0.0
    for rid in forced:
        d, w = held_to(f"{SLOTS_B} slots, request {rid} (slot {rid}), teacher-forced",
                       step_log.logits[rid], ref[rid], REGIME_REL_TOL, forced=True)
        worst = max(worst, w)
        if d:
            differ[rid] = d
    decode_s = sum(step_log.decode_s)
    step_ms = sorted(1e3 * t for t in step_log.decode_s)
    kv = sum(kv_cache_bytes(c) for c in step_log.loop.caches)
    tokens = SLOTS_B * steps
    res = dict(card=card, slots=SLOTS_B, prompt_lens=[int(n) for n in lens], forced=forced,
               decode_steps=steps, launches=launches, regime_b_calls=len(gemm_calls),
               step_ms_median=step_ms[len(step_ms) // 2], step_ms_max=step_ms[-1],
               decode_tok_per_s=tokens / decode_s, prefill_s=sum(step_log.prefill_s),
               wall_s=wall, kv_bytes=kv, peak_gb=peak / 1e9, rel_max=worst,
               tokens_differ_at=differ)
    log(f"{SLOTS_B} slots: {SLOTS_B} admissions, then {steps} decode steps in regime B "
        f"({len(gemm_calls)} K3 GEMM calls at M={SLOTS_B}); step median "
        f"{res['step_ms_median']:.2f} ms, max {res['step_ms_max']:.2f} ms, "
        f"{res['decode_tok_per_s']:.1f} tok/s; {SLOTS_B} prefills {res['prefill_s']:.2f} s; KV "
        f"{kv / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB ({card})")
    log(f"{SLOTS_B} slots: {len(forced)} teacher-forced requests within {worst:.2e} x "
        f"max|logit| of generate's (tol {REGIME_REL_TOL}), tokens differing at a near tie: "
        f"{differ or 'none'}; launches {launches}")
    del step_log, done
    torch.cuda.empty_cache()
    return res


def serve_options(model, reqs, served, dev, seed, card, report) -> dict:
    """Phase 24: the serving loop's options on phase 5's model (built once):
    chunked prefill, sampling, and decode past 128 slots. Returns each
    part's launch counts."""
    res = dict(chunked=chunked_prefill(model, reqs, served, dev),
               sampled=sampled_loops(model, reqs, dev, seed),
               slots_b=decode_past_128(model, dev, seed, card))
    report["serve_options"] = res
    return {"chunked_dense": res["chunked"]["dense"]["launches"],
            "chunked_paged": res["chunked"]["paged"]["launches"],
            "sampled": res["sampled"]["launches"], f"slots_{SLOTS_B}": res["slots_b"]["launches"]}


# ---------------------------------------------------------------- phase 25


# MobileNetV2 W8A8 at the batch of its benchmark cell
MOBILENET_BATCH = 1024
# MobileNetV2's engine against its fake-quant model: FQ_TOL's cause over 52
# quantized convs whose ReLU6 caps carry an edge-rounded code further. The
# benchmark's plain reference, equal to the fake-quant model to 1e-5
# (tests/test_torch_mobilenet_v2.py), reads the engine 0.17 to 0.23 of the
# largest logit away at most over 8,192 rows (PERF.md, the MobileNetV2 cell)
MOBILENET_FQ_TOL = 0.4
# calls a device reading of one depthwise layer, each route
DWCONV_ITERS = 20


def _conv_kinds(convs):
    """Each ``IntConv2d`` of MobileNetV2 in order -> its part: the stem,
    an expansion (the conv before a depthwise one), the depthwise conv, a
    projection (the conv after it) or the head."""
    kinds = []
    for i, m in enumerate(convs):
        nxt = convs[i + 1] if i + 1 < len(convs) else None
        kinds.append("stem" if i == 0 else "depthwise" if m.depthwise
                     else "expansion" if nxt is not None and nxt.depthwise
                     else "projection" if convs[i - 1].depthwise else "head")
    return kinds


def _dwconv_cases(engine, x, dtypes=None):
    """For each depthwise ``IntConv2d`` of ``engine`` in order, on its own
    input in one forward of ``x`` (kept by a hook): its name, the module
    and the operator's arguments over its int8 codes, as
    ``IntConv2d.dwconv`` passes them. ``dtypes``, a list, receives every
    conv's input dtype by its part (:func:`_conv_kinds`)."""
    from micronet_tpu_torch.infer import engine as E
    from micronet_tpu_torch.ops.dwconv import dw_weight

    convs = [(n, m) for n, m in engine.named_modules() if isinstance(m, E.IntConv2d)]
    kinds = _conv_kinds([m for _, m in convs])
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args: inputs.__setitem__(mod, args[0]))
             for _, m in convs]
    try:
        engine(x)
    finally:
        for h in hooks:
            h.remove()
    if dtypes is not None:
        dtypes.extend((k, str(inputs[m].dtype)[6:]) for k, (_, m) in zip(kinds, convs))
    for (lname, m), kind in zip(convs, kinds):
        x_in = inputs.pop(m)
        if kind != "depthwise":
            continue
        x_q = x_in if x_in.dtype == torch.int8 else E._act_codes(
            x_in, m.act_scale, m.act_zero_point, m.a_qmin, m.a_qmax, True)
        wt = m._cached("_dw_cache", lambda: dw_weight(m._weights()))
        yield lname, m, (x_q, wt, m.act_scale, m.w_scale, m.bias, m.out_scale, list(m.stride),
                         list(m.padding), m.out_qmin, m.out_qmax, m.chained)


def _block_diagonal(m, x_q):
    """The route every other grouped conv takes, on the depthwise conv
    ``m``: im2col, the int32 GEMM over the block-diagonal weight, the conv
    epilogue; (N, Ho, Wo, C), the depthwise kernel's layout."""
    return m._epilogue(m._int_acc_im2col(x_q), m.w_scale).permute(0, 2, 3, 1)


def _dwconv_bound_ms(args, out) -> float:
    """The larger of the layer's operations (2 x 9 MACs an output) over the
    int8 peak and its bytes over 3.35 TB/s: int8 codes in once, the
    weights once and int8 codes out once, whatever the route writes."""
    x_q = args[0]
    n, c, h, w = x_q.shape
    ho, wo = out.shape[1:3]
    ops = 2 * 9 * n * c * ho * wo
    n_bytes = n * c * (h * w + ho * wo) + 9 * c
    return max(ops / INT8_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3


@torch.no_grad()
def mobilenet_engine(dev, seed, report, profile_dir=None, later=None, keep=None):
    """Phase 25: full-width ``mobilenet_v2()`` (CIFAR strides, 10 classes),
    W8A8 with fused BN, through phase 9's engine path at batch 1,024.
    Counts zeroed just before the engine forwards and read just after: the
    depthwise kernel (``ops/dwconv.py``) once a depthwise conv, 17 a
    forward; the conv epilogue once every other conv, 35; K1 once (the
    classifier); nothing else. Then each depthwise conv on its own int8
    input from one forward: the kernel equal bit for bit to its twin and
    to the block-diagonal route (f32 outputs as int32), beside the layer's
    bound; every depthwise conv and every projection must read int8 codes
    (the chains). ``keep`` receives the engine and its input (the device
    times, :func:`dwconv_device_times`)."""
    from micronet_tpu_torch.infer import engine as E
    from micronet_tpu_torch.models.mobilenet_v2 import mobilenet_v2
    from micronet_tpu_torch.ops.dwconv import dwconv_int8, dwconv_int8_ref
    from micronet_tpu_torch.quant.config import QuantConfig

    name = "mobilenetv2_w8a8"
    keep = {} if keep is None else keep
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True, **EXACT)
    torch.cuda.reset_peak_memory_stats()
    launches, forwards = engine_path(name, mobilenet_v2, cfg, MOBILENET_BATCH, dev, seed, report,
                                     profile_dir, later, keep=keep, fq_tol=MOBILENET_FQ_TOL)
    res, engine = report[name], keep["engine"]
    convs = [m for m in engine.modules() if isinstance(m, E.IntConv2d)]
    n_dw = sum(m.depthwise for m in convs)
    k1 = sum(isinstance(m, E.IntLinear) and m.symmetric and m.w_symmetric
             for m in engine.modules())
    want = {k.__name__: 0 for k in _all_kernels()}
    want["int8_matmul_dequant"] = k1 * forwards
    if (launches != want or n_dw != 17 or res["dwconv_launches"] != n_dw * forwards
            or res["epilogue_launches"] != (len(convs) - n_dw) * forwards):
        fail(f"{name}: launch counts {launches} (expected {want}), depthwise kernel "
             f"{res['dwconv_launches']} and conv epilogue {res['epilogue_launches']} over "
             f"{forwards} forwards of {n_dw} depthwise convs (17 expected) and "
             f"{len(convs) - n_dw} others")
    dtypes, layers = [], []
    for lname, m, args in _dwconv_cases(engine, keep["x"], dtypes):
        got = dwconv_int8(*args)
        same = {}
        for route, ref in (("twin", dwconv_int8_ref(*args)),
                           ("block_diagonal", _block_diagonal(m, args[0]))):
            a, b = (got, ref) if got.dtype != torch.float32 else (got.view(torch.int32),
                                                                   ref.view(torch.int32))
            same[route] = a.dtype == b.dtype and torch.equal(a, b)
        n, c, h, _ = args[0].shape
        layers.append(dict(layer=lname, c=c, h=h, stride=m.stride[0], out=str(got.dtype)[6:],
                           nhwc_input=args[0].permute(0, 2, 3, 1).is_contiguous(),
                           bound_ms=_dwconv_bound_ms(args, got),
                           **{f"equal_{k}": v for k, v in same.items()}))
        del got, args
    chains = {}
    for kind, dtype in dtypes:
        chains.setdefault(kind, {}).setdefault(dtype, 0)
        chains[kind][dtype] += 1
    if not all(r["equal_twin"] and r["equal_block_diagonal"] for r in layers):
        fail(f"{name}: depthwise kernel against its twin and the block-diagonal route: "
             f"{[(r['layer'], r['equal_twin'], r['equal_block_diagonal']) for r in layers]}")
    if set(chains["depthwise"]) != {"int8"} or set(chains["projection"]) != {"int8"}:
        fail(f"{name}: conv inputs by part {chains}: every depthwise conv and projection "
             f"should read int8 codes")
    res.update(dwconv_layers=layers, conv_inputs=chains)
    _check_patches(name, report, 1, keep)
    log(f"{name}: depthwise kernel {res['dwconv_launches']} launches over {forwards} forwards, "
        f"equal bit for bit to its twin and to the block-diagonal route at all {n_dw} "
        f"depthwise convs; conv inputs by part {chains}; peak {res['peak_gb']:.2f} GB")
    return res["dwconv_launches"]


@torch.no_grad()
def dwconv_device_times(keep, report):
    """Phase 25's depthwise convs on their own int8 inputs from one forward:
    ms by events and device ms (``torch.profiler``) of the kernel and of
    the block-diagonal route (:func:`_block_diagonal`), beside each
    layer's bound. Returns the kernels line's ``dwconv_int8`` row's
    fields: the sums over the 17 layers and the layers."""
    from micronet_tpu_torch.ops.dwconv import dwconv_int8

    layers = report["mobilenetv2_w8a8"]["dwconv_layers"]
    for row, (_, m, args) in zip(layers, _dwconv_cases(keep["engine"], keep["x"])):
        x_q = args[0]

        def block_diagonal(x_q, m=m):
            return _block_diagonal(m, x_q)

        row.update(ms=time_ms(dwconv_int8, [args], DWCONV_ITERS),
                   device_ms=device_ms(dwconv_int8, [args], DWCONV_ITERS),
                   plain_ms=time_ms(block_diagonal, [(x_q,)], DWCONV_ITERS),
                   plain_device_ms=device_ms(block_diagonal, [(x_q,)], DWCONV_ITERS))
        del x_q, args
        torch.cuda.empty_cache()
    out = {key: sum(r[key] for r in layers)
           for key in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms")}
    log(f"depthwise kernel, mobilenetv2_w8a8 at {MOBILENET_BATCH}: {len(layers)} layers, device "
        f"{out['device_ms']:.4f} ms (events {out['ms']:.4f}), block-diagonal route device "
        f"{out['plain_device_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_ms'] / out['device_ms']:.1%} of it)")
    for r in layers:
        log(f"  {r['layer']:<36} C {r['c']:>4} H {r['h']:>2} s {r['stride']} -> {r['out']:<7} "
            f"device {r['device_ms']:.4f} ms, block-diagonal {r['plain_device_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['device_ms']:.1%})")
    out["layers"] = layers
    return out


def card_name() -> str:
    """Card 0's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip()


def slice12_alone(dev, seed, card, report, out_dir: Path, profile: bool, t_start) -> int:
    """``--slice12``: phase 5 (whose model and requests phase 24 takes),
    phase 24, then phase 23, with ``--profile``'s traces of phase 23's
    engines; the report goes to ``<out>/chip_smoke.json``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    phase5 = {}
    serve(dev, seed, report, keep=phase5)
    t1 = time.perf_counter()
    serve_options(phase5["model"], phase5["reqs"], phase5["outputs"], dev, seed, card, report)
    t2 = time.perf_counter()
    del phase5
    torch.cuda.empty_cache()
    bottleneck_lenet_engines(dev, seed, report, out_dir if profile else None)
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"phase 24 {t2 - t1:.1f} s, phase 23 {time.perf_counter() - t2:.1f} s; total "
        f"{report['seconds']:.1f} s")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 5 decode steps of each serving loop and 3 forwards "
                         "of each engine with torch.profiler")
    ap.add_argument("--out", type=Path, default=Path("build/chip_smoke"),
                    help="directory for the JSON report and the profile table")
    ap.add_argument("--slice12", action="store_true",
                    help="run only phase 5 and slice 12's phases 24 and 23 (after the build), "
                         "and print no final line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from micronet_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_name()
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
    if args.slice12:
        return slice12_alone(dev, args.seed, card, report, args.out, args.profile, t_start)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k3 = check_k3(dev, gen, report)
    att = check_attention(dev, gen, report)
    report["reference_max_abs"] = check_reference(dev)
    out_dir = args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    profile_dir = out_dir if args.profile else None
    # --profile's traces of phases 6, 9 and 11, taken after phase 12's
    # device readings: after a traced serving run, those readings lost
    # kernels from their traces
    later = []
    phase5 = {}
    launches = serve(dev, args.seed, report, profile_dir, later, keep=phase5)
    # phase 24 on phase 5's model, before phase 11 builds its own
    opt_launches = serve_options(phase5["model"], phase5["reqs"], phase5["outputs"], dev,
                                 args.seed, card, report)
    del phase5
    torch.cuda.empty_cache()
    k1 = check_k1(dev, gen, report)
    check_conv_routes(dev, gen, report)
    # each kernel's count from its own slice's main path
    engines = {name: {} for name in DEPLOY_PROFILES}  # phase 9's engines, for phase 19
    launches["int8_matmul_dequant"] = resnet_engine(dev, args.seed, report, profile_dir, later,
                                                    engines["resnet18_w8a8"])["int8_matmul_dequant"]
    nin_engine(dev, args.seed, report, profile_dir, later, engines["nin_gc_w4a4"])
    k1_phase23 = bottleneck_lenet_engines(dev, args.seed, report, profile_dir, later)
    mnet = {}  # phase 25's engine, for its device times
    mobilenet_engine(dev, args.seed, report, profile_dir, later, mnet)
    long_att = check_long_attention(dev, gen, report)
    launches.update({k: v for k, v in serve_long(dev, args.seed, card, report, profile_dir,
                                                 later).items()
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
    epi = epilogue_device_times(engines, report)
    dw = dwconv_device_times(mnet, report)
    patches = patch_device_times({"nin_gc_w4a4": engines["nin_gc_w4a4"],
                                  "resnet18_w8a8": engines["resnet18_w8a8"],
                                  "mobilenetv2_w8a8": mnet}, report)
    del mnet
    torch.cuda.empty_cache()
    dec_kernels = decoder_kernel_times(dev, gen, report)
    # phase 19 runs here, before --profile's traces: after them, its replay
    # traces lost kernels
    k1_phase19 = deploy(engines, dev, args.seed, out_dir, card, report, profile_dir)
    shared = keep_parallel_engine(engines["resnet18_w8a8"]["engine"], dev, args.seed, out_dir)
    del engines
    k1_op = k1_operator_times(dev, gen, report)
    for run in later:
        run()
    later.clear()
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in wbwtab_engine(dev, args.seed, report, profile_dir).items()
                     if k in WBWTAB_KERNELS})
    train_res = train_nin_gc(dev, args.seed, out_dir, card, report)
    k1_phase15 = ptq_resnet18(dev, args.seed, out_dir, card, report)
    prune_nin(dev, args.seed, out_dir, card, report)
    asym_nin_gc(dev, args.seed, out_dir, card, report, profile_dir)
    asym_resnet18(dev, args.seed, card, report, profile_dir)
    upcat_engines(dev, args.seed, report, profile_dir)
    dec_launches = serve_decoder(dev, args.seed, card, report, profile_dir)
    training_lowerings(dev, args.seed, out_dir, card, report, train_res)
    torch.cuda.empty_cache()
    k1_phase21 = parallel(dev, args.seed, shared, card, report, args.profile)
    torch.cuda.empty_cache()
    srv = serving_parallel(dev, args.seed, shared, card, report)
    tp_key = next(k for k in srv if k.startswith("llama_tp"))
    k3_tp = k3_tp_times(dev, gen, report)

    src = "micronet_tpu_torch/ops/csrc/"
    long_per = (f"one call, G={ATT_G} R={ATT_R} D={ATT_D} S={LONG_CTX}, bounds 0..{LONG_CTX}")
    paged_per = (f"one call, {SLOTS} slots x {ATT_G // SLOTS} KV heads, R={ATT_R}, pages of "
                 f"{PAGE}, S={LONG_CTX}, lengths 0..{LONG_CTX}; library_ms is SDPA on the "
                 f"gathered bf16 view, the gather not timed")
    rows = [
        dict(name="int4_matmul_grouped_hl8", route="cuda", source=src + "int4_matmul.cu",
             replaces="micronet_tpu/ops/int4_matmul.py:548",
             launches=launches["int4_matmul_grouped_hl8"],
             per="one decode step at M=8: 129 calls over the five 8B shapes; launches_phase18 "
                 "is its count over each TinyDecoder form's serving loop (phase 18), phase18 "
                 "its times at M=1 for one slot's decode forward there; launches_phase22 its "
                 "counts on rank 0 over phase 22's tensor-parallel loops (the Llama's dense "
                 "and paged loops and generate, the TinyDecoder's loop), phase22 one rank's "
                 "decode step at M=8 at each tp (129 calls at N / tp, split_cols N); "
                 f"m{K3_SLOTS_B}_* one decode step's 129 calls at M={K3_SLOTS_B} (regime B, "
                 "phase 24's loop past 128 slots); launches_phase24 its counts over phase "
                 "24's loops (chunked prefill dense and paged; the sampled loops with each "
                 f"request's generate or generate_sampled; the {K3_SLOTS_B}-slot loop)",
             phase22=k3_tp,
             launches_phase18={f: v["int4_matmul_grouped_hl8"] for f, v in dec_launches.items()},
             launches_phase22={k: {p: c["int4_matmul_grouped_hl8"] for p, c in v.items()}
                               if k.startswith("llama") else v["int4_matmul_grouped_hl8"]
                               for k, v in srv.items()},
             launches_phase24={k: v["int4_matmul_grouped_hl8"] for k, v in opt_launches.items()},
             phase18=dict(dec_kernels["k3_per_slot_step"],
                          max_abs_err=dec_kernels["k3_max_abs_err"]), **k3),
        dict(name="decode_attend_q8kv_cur", route="cuda", source=src + "decode_attention.cu",
             replaces="micronet_tpu/ops/decode_attention.py:519",
             launches=launches["decode_attend_q8kv_cur"],
             per=f"one call, G={ATT_G} R={ATT_R} D={ATT_D} S={ATT_S}; launches_phase22 its "
                 "count on rank 0 over phase 22's tensor-parallel dense loop; "
                 "launches_phase24 its counts over phase 24's dense loops (chunked, sampled, "
                 f"{K3_SLOTS_B} slots: G={K3_SLOTS_B * 8})",
             launches_phase22=srv[tp_key]["dense"]["decode_attend_q8kv_cur"],
             launches_phase24={k: v["decode_attend_q8kv_cur"] for k, v in opt_launches.items()},
             **att["decode_attend_q8kv_cur"]),
        dict(name="decode_attend_q8kv", route="cuda", source=src + "decode_attention.cu",
             replaces="micronet_tpu/ops/decode_attention.py:107",
             launches=launches["decode_attend_q8kv"],
             per=f"one call, G={ATT_G} R={ATT_R} D={ATT_D} S={ATT_S}; launches_phase18 is its "
                 "count over each TinyDecoder form's serving loop (phase 18), phase18 one call "
                 "there (G=8 R=1 D=16 S=64, bounds 0..64); launches_phase22 its counts on rank 0 "
                 "over phase 22's tensor-parallel generate and TinyDecoder loop; "
                 "launches_phase24 its count over phase 24's generate and generate_sampled runs",
             launches_phase18={f: v["decode_attend_q8kv"] for f, v in dec_launches.items()},
             launches_phase22=dict(generate=srv[tp_key]["generate"]["decode_attend_q8kv"],
                                   decoder_tp=srv["decoder_tp"]["decode_attend_q8kv"]),
             launches_phase24=opt_launches["sampled"]["decode_attend_q8kv"],
             phase18=dec_kernels["k5a"], **att["decode_attend_q8kv"]),
        dict(name="int8_matmul_dequant", route="cuda", source=src + "int_matmul.cu",
             replaces="micronet_tpu/ops/int_matmul.py:114",
             launches=launches["int8_matmul_dequant"],
             per="one call at M=512 K=512 N=10 (ResNet-18's fc at batch 512); library_ms is "
                 "torch._int_mm on codes quantized beforehand: the integer product only; "
                 "launches_phase15 is its count over the KL-PTQ ResNet-18 engine's "
                 f"{ENGINE_ITERS + 1} forwards after cli freeze-int; launches_phase19 its "
                 "count over the ResNet-18 deploy path (two warm-up forwards and one capture "
                 "a bucket; a CUDA graph's replay runs it once by torch.profiler and counts "
                 "nothing); operator the wrapper through the registered operator, the same "
                 "launch without it and one call in a replayed graph, by events; "
                 "launches_phase21 its count on NCCL rank 0 over the sharded engine's build "
                 "(two warm-ups and a capture of one bucket) and a call (phase 21); "
                 "launches_phase23 its counts over phase 23's engines' forwards (ResNet-50's "
                 "fc, LeNet's three Linears), cases_phase23 its calls at ResNet-50's fc "
                 "(M=512 K=2048 N=10) and LeNet's first Linear (M=1024 K=400 N=120)",
             launches_phase23=k1_phase23,
             cases_phase23={label: {k: v for k, v in report["k1_cases"][label].items()
                                    if k not in ("zp", "qmin", "qmax")}
                            for label in ("resnet50_fc", "lenet_fc1")},
             launches_phase15=k1_phase15, launches_phase19=k1_phase19,
             launches_phase21=k1_phase21, operator=k1_op,
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
             launches=launches["paged_decode_attend_cur"],
             per=paged_per + "; launches_phase22 its count on rank 0 over phase 22's "
                             "tensor-parallel paged loop; launches_phase24 its counts over "
                             "phase 24's paged loops (chunked, sampled)",
             launches_phase22=srv[tp_key]["paged"]["paged_decode_attend_cur"],
             launches_phase24={k: v["paged_decode_attend_cur"]
                               for k, v in opt_launches.items() if "paged" in k
                               or k == "sampled"},
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
        dict(name="requant_epilogue", route="cuda", source=src + "requant_epilogue.cu",
             replaces="micronet_tpu/infer/engine.py:165 (IntConv2d._epilogue, fused by XLA)",
             launches=sum(v["launches_phase9"] for v in epi.values()),
             per="every symmetric conv of one forward, summed, on phase 9's engines: "
                 f"nin_gc_w4a4 at {NIN_BATCH} (9 convs), resnet18_w8a8 at {RESNET_BATCH} "
                 f"(20); launches over phase 9's {ENGINE_ITERS + 1} forwards of each; "
                 f"{EPILOGUE_ITERS} calls a layer; plain_* is the twin (the chain of PyTorch "
                 "operations) on the card; bound_ms M x O x (4 + 1) for int8 out, x (4 + 4) "
                 "for f32, at 3.35 TB/s; layers per conv",
             **epi),
        dict(name="dwconv_int8", route="cuda", source=src + "dwconv_int8.cu",
             replaces="micronet_tpu/infer/engine.py:319 (a grouped conv through XLA; the "
                      "port's other grouped convs run one GEMM over a block-diagonal weight)",
             launches=report["mobilenetv2_w8a8"]["dwconv_launches"],
             per=f"the 17 depthwise convs of one MobileNetV2 W8A8 forward at batch "
                 f"{MOBILENET_BATCH}, summed, each on its own int8 input from phase 25's main "
                 f"path; launches over its {ENGINE_ITERS + 1} forwards; {DWCONV_ITERS} calls "
                 "a layer; plain_* is the block-diagonal route on the same input (im2col, "
                 "torch._int_mm over the block-diagonal weight, the conv epilogue); bound_ms "
                 "per layer the larger of 2 x MACs at 1,979 TOP/s and int8 codes in and out "
                 "once and the weights once at 3.35 TB/s; layers per conv",
             **dw),
        dict(name="patch_gather", route="cuda", source=src + "patch_gather.cu",
             replaces="none: micronet_tpu/infer/engine.py leaves its convolutions to XLA "
                      "(lax.conv_general_dilated) and its shuffle is an XLA gather",
             launches=sum(v["launches_main_path"] for v in patches.values()),
             per=f"every patch-gather call of one forward, summed, each on its own input: "
                 f"nin_gc_w4a4 at {NIN_BATCH} (9: the stem's f32 patches, two 3 x 3 convs, "
                 f"six int8 shuffles), resnet18_w8a8 at {RESNET_BATCH} (20: the stem, 16 "
                 f"3 x 3 convs, 3 strided shortcuts), mobilenetv2_w8a8 at {MOBILENET_BATCH} "
                 f"(1: the stem); launches over each engine's {ENGINE_ITERS + 1} main-path "
                 f"forwards; {PATCH_ITERS} calls a layer; plain_* is the twin on the card "
                 "(PyTorch's pad and unfold copies, the shuffle's reshape and transpose); "
                 "bound_ms the input read once and the output written once at 3.35 TB/s; "
                 "layers per call",
             **patches),
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
