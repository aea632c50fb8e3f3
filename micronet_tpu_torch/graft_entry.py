"""A compile-and-run entry point: the counterpart of ``__graft_entry__.entry()``.

    from micronet_tpu_torch.graft_entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    with torch.no_grad():
        logits = fn(*args)        # (64, 10)

The forward is the flagship configuration's eval forward: NIN-GC at its
default widths, IAO W8A8 with per-channel weights and BN folded in
training (``QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)``), in eval
mode. The config keeps the default ``"auto"`` lowerings, so on the card
the forward runs the code-storage convs (bf16 codes) and on the CPU the
exact f32 composition. The weights are drawn from a CPU generator seeded
with 0, so every device gets the same ones; the example input is a zero
batch of 64 NHWC images, as the JAX entry's.

``dryrun_multichip(n)`` is the training half of the JAX package's
multi-chip dry run: it starts ``n`` ranks (one process a card over NCCL,
or over gloo with ``device="cpu"``), lays out a ``(n / tp, tp)`` mesh
(``tp`` 2 where ``n`` is even) and runs one IAO W8A8 ``bn_fuse`` step of
NIN (widths 8) with the model and Adam channel-sharded, checking that
every data replica holds the same observer ranges and BN running means
bit for bit; then an asymmetric (``q_type=1``) step and a PTQ-KL
calibration forward over the same mesh. With ``serving=True`` the ranks
then run its serving half at the JAX dry run's sizes and tolerances:
the W4 TinyDecoder and W4 Llama tensor-parallel over ``model``
(``forward``, ``decode_batch``, ``decode_batch_paged`` with its active
mask and page count, Llama within 1e-4 of the unsharded model), the
quantized IAO pipeline against its sequential fold (1e-3), expert-parallel
MoE forward and backward against the dense oracle (1e-5), the
sequence-parallel prefill (2e-5, the int8 codes equal), ring attention
forward and backward (1e-5) and the EP MoE decoder (2e-5). The stage,
expert and seq axes take every rank (``parallel.sharding.axis_mesh``),
where the JAX dry run takes ``min(4, n)`` devices: the sizes agree up to
four ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ._device import resolve_device

__all__ = ["entry", "dryrun_multichip"]

EXAMPLE_BATCH = 64


def entry(device=None) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor, ...]]:
    """``(fn, example_args)``: ``fn`` is the prepared NIN-GC (an
    ``nn.Module`` in eval mode) on ``device`` (None means CUDA, which
    raises without a card), ``example_args`` its (64, 32, 32, 3) f32 zero
    input."""
    from .models import nin_gc
    from .nn import eval_mode, prepare
    from .quant.config import QuantConfig

    dev = resolve_device(device)
    model = nin_gc.Net(device="cpu", generator=torch.Generator().manual_seed(0))
    q = prepare(model, QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), method="iao",
                device="cpu")
    fn = eval_mode(q).to(dev)
    return fn, (torch.zeros((EXAMPLE_BATCH, 32, 32, 3), device=dev),)


def _stage_fn(module):
    """A pipeline stage function over ``module``'s structure:
    ``(params, state, h) -> (h_out, state')`` through
    ``torch.func.functional_call`` (writes to the module's buffers land
    in the returned state)."""
    from torch.func import functional_call

    def fn(params, state, h):
        tensors = {**params, **state}
        out = functional_call(module, tensors, (h,))
        return out, {k: tensors[k] for k in state}

    return fn


def _close(what: str, got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> None:
    if got.shape != ref.shape or not torch.allclose(got, ref, rtol=rtol, atol=atol):
        diff = (got - ref).abs().max().item() if got.shape == ref.shape else float("nan")
        raise RuntimeError(f"{what}: max|diff| {diff:.3e} (rtol {rtol}, atol {atol})")


def _serving_checks(n: int, dev: torch.device, mesh, tp: int) -> str:
    """The serving half of the dry run on every rank (module docstring)."""
    import copy

    from .models.llama import Llama, LlamaConfig, quantize_llama
    from .models.nin import ConvBNReLU
    from .models.tiny_decoder import TinyDecoder, quantize_decoder
    from .nn import prepare, train_mode
    from .parallel import (attention_reference, init_moe, moe_apply, moe_apply_ep,
                           pipeline_apply_stateful, quantize_moe, ring_attention, shard_state,
                           stack_stage_params)
    from .parallel.sharding import axis_mesh
    from .quant.config import QuantConfig

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # the W4 TinyDecoder and W4 Llama, channel-sharded over 'model'
    dec = shard_state(quantize_decoder(TinyDecoder(vocab=32, dim=16, heads=tp * 2, depth=1,
                                                   mlp_dim=32, max_seq=8, device=dev,
                                                   generator=gen(0)), group=8), mesh)
    z = torch.zeros((3,), dtype=torch.int64, device=dev)
    _, caches = dec.forward(z, dec.init_cache(), 0)
    logits2, _ = dec.forward(z[:1], caches, 3)
    if not torch.isfinite(logits2).all():
        raise RuntimeError("tp decoder produced non-finite logits")
    lcfg = LlamaConfig(vocab=32, dim=8 * tp, n_layers=1, n_heads=2 * tp, n_kv_heads=tp,
                       mlp_dim=16 * tp, max_seq=8, rope_theta=10000.0)
    lm = quantize_llama(Llama(lcfg, device=dev, generator=gen(0)), group=4)
    ltoks = torch.tensor([1, 2, 3], device=dev)
    lref, _ = lm.forward(ltoks, lm.init_cache(), 0)
    lsh_model = shard_state(copy.deepcopy(lm), mesh)
    lsh, lcaches = lsh_model.forward(ltoks, lsh_model.init_cache(), 0)
    _close("tp-sharded llama against the single device", lsh, lref, 1e-4, 1e-4)
    ldec, _ = lsh_model.forward(torch.tensor([5], device=dev), lcaches, 3)
    if not torch.isfinite(ldec).all():
        raise RuntimeError("llama decode produced non-finite logits")

    # the quantized pipeline (IAO bn_fuse stages, state gated off the
    # bubble ticks) forward and backward against the sequential fold
    pp = n
    pp_mesh = axis_mesh("stage", pp, device=dev.type)
    c, n_micro, micro = 8, 2 * pp, 2
    stages = [train_mode(prepare(ConvBNReLU(c, c, 3, stride=1, padding=1, device="cpu",
                                            generator=torch.Generator().manual_seed(i)),
                                 QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), method="iao",
                                 device="cpu")).to(dev) for i in range(pp)]
    plist = [{k: v.detach() for k, v in m.named_parameters()} for m in stages]
    rlist = [{k: v.detach() for k, v in m.named_buffers()} for m in stages]
    stacked_p = {k: v.requires_grad_() for k, v in stack_stage_params(plist).items()}
    stacked_r = stack_stage_params(rlist)
    stage_fn = _stage_fn(stages[0])
    px = torch.randn((n_micro, micro, c, 8, 8), device=dev, generator=gen(3))
    out, pp_state = pipeline_apply_stateful(stage_fn, stacked_p, stacked_r, px, pp_mesh)
    pp_val = torch.mean(out ** 2)
    pp_val.backward()
    rests = [{k: v.clone() for k, v in r.items()} for r in rlist]
    outs = []
    with torch.no_grad():
        for mb in range(n_micro):
            hh = px[mb]
            for si in range(pp):
                hh, rests[si] = stage_fn(plist[si], rests[si], hh)
            outs.append(hh)
    _close("quantized pipeline against the sequential fold", pp_val.detach(),
           torch.mean(torch.stack(outs) ** 2), 1e-3, 0.0)
    if not (all(torch.isfinite(p.grad).all() for p in stacked_p.values())
            and all(torch.isfinite(v.float()).all() for v in pp_state.values())):
        raise RuntimeError("pipeline gradients or state not finite")

    # expert parallelism: int8 experts over 'expert', forward and backward
    ep = n
    ep_mesh = axis_mesh("expert", ep, device=dev.type)
    moe = quantize_moe(init_moe(8, 16, 2 * ep, device=dev, generator=gen(0)))
    mx = torch.randn((16, 8), device=dev, generator=gen(1))
    router = moe.router.clone().requires_grad_()
    ep_val = torch.mean(moe_apply_ep(dataclasses.replace(moe, router=router), mx, ep_mesh,
                                     capacity_factor=2.0) ** 2)
    ep_val.backward()
    _close("EP MoE against the dense oracle", ep_val.detach(),
           torch.mean(moe_apply(moe, mx, 2.0) ** 2), 1e-5, 0.0)
    if not torch.isfinite(router.grad).all():
        raise RuntimeError("EP MoE router gradient not finite")

    # sequence parallelism: the W4 decoder's prefill over 'seq', then ring
    # attention forward and backward against the dense oracle
    sp = n
    sp_mesh = axis_mesh("seq", sp, device=dev.type)
    sp_dec = quantize_decoder(TinyDecoder(vocab=32, dim=16, heads=2, depth=1, mlp_dim=32,
                                          max_seq=2 * sp + 2, device=dev, generator=gen(0)),
                              group=8)
    sp_toks = torch.arange(2 * sp, device=dev) % 32
    sp_logits, sp_caches = sp_dec.prefill_sp(sp_toks, sp_dec.init_cache(), sp_mesh)
    dense_logits, dense_caches = sp_dec.forward(sp_toks, sp_dec.init_cache(), 0)
    _close("sp prefill against the dense prefill", sp_logits, dense_logits, 0.0, 2e-5)
    if not torch.equal(sp_caches[0].k_codes, dense_caches[0].k_codes):
        raise RuntimeError("sp prefill wrote other int8 KV codes")
    sq, sk, sv = (torch.randn((4 * sp, 2, 8), device=dev, generator=gen(2 + i))
                  for i in range(3))
    sq.requires_grad_()
    sp_val = torch.mean(ring_attention(sq, sk, sv, sp_mesh, causal=True) ** 2)
    sp_val.backward()
    with torch.no_grad():
        _close("ring attention against the dense oracle", sp_val.detach(),
               torch.mean(attention_reference(sq, sk, sv, causal=True) ** 2), 1e-5, 0.0)
    if not torch.isfinite(sq.grad).all():
        raise RuntimeError("ring attention gradient not finite")

    # the EP MoE decoder against the dense path
    def moe_dec():
        return quantize_decoder(TinyDecoder(vocab=32, dim=16, heads=2, depth=1, mlp_dim=32,
                                            max_seq=8, moe_experts=2 * ep, device=dev,
                                            generator=gen(1)), group=8)

    ep_dense, ep_dec = moe_dec(), moe_dec()
    for blk in ep_dec.blocks:
        blk.moe.use_ep(ep_mesh)
    ep_toks = torch.arange(4, device=dev)
    _close("EP MoE decoder against the dense path",
           ep_dec.forward(ep_toks, ep_dec.init_cache(), 0)[0],
           ep_dense.forward(ep_toks, ep_dense.init_cache(), 0)[0], 0.0, 2e-5)

    # the batched decode step ServeLoop rides, tp-sharded, then paged
    bsz = 2
    btoks = torch.tensor([[1], [2]], device=dev)
    boffs = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    lref_b, _ = lm.decode_batch(btoks, lm.init_cache_batch(bsz), boffs)
    lsh_b, bcaches2 = lsh_model.decode_batch(btoks, lsh_model.init_cache_batch(bsz), boffs)
    _close("tp-sharded decode_batch against the single device", lsh_b, lref_b, 1e-4, 1e-4)
    lsh_b2, _ = lsh_model.decode_batch(btoks, bcaches2, boffs + 1)
    pcaches = lsh_model.init_paged_cache(slots=bsz, page_size=4, num_pages=9)
    top0 = int(pcaches[0].free_top)
    lp, pcaches2 = lsh_model.decode_batch_paged(btoks, pcaches, boffs,
                                                torch.tensor([True, False], device=dev))
    if not (torch.isfinite(lsh_b2).all() and torch.isfinite(lp).all()):
        raise RuntimeError("batched or paged decode produced non-finite logits")
    if pcaches2[0].lengths.tolist() != [1, 0]:
        raise RuntimeError("the paged append did not respect the active mask")
    if int(pcaches2[0].free_top) != top0 - 1:
        raise RuntimeError("the paged append allocated another page count than one")
    return (f"decoder and llama tp ok, pp={pp}-stage quantized pipeline fwd+bwd ok, ep={ep} "
            f"int8-MoE fwd+bwd + EP-MoE decoder ok, sp={sp} ring-attention fwd+bwd + "
            f"sp-prefill ok, decode_batch and decode_batch_paged tp ok")


def _dryrun_rank(rank: int, n: int, port: int, device, serving: bool = False) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as TF

    from .models import nin
    from .nn import prepare, qat_iao, train_mode
    from .parallel import initialize, make_mesh, shard_batch, shard_model_and_optimizer
    from .parallel.distributed import _gather_parts, batch_reduction
    from .parallel.sharding import batch_group_for
    from .quant.config import QuantConfig
    from .train.optim import Adam

    initialize(f"tcp://localhost:{port}", n, rank, device=device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh(dp, tp, device=device)
    batch = 2 * dp
    x = torch.ones((batch, 32, 32, 3), device=dev)
    y = torch.zeros((batch,), dtype=torch.int64, device=dev)
    group = batch_group_for(batch, mesh)

    def step(cfg: QuantConfig, seed: int, train: bool = True):
        q = train_mode(prepare(nin.Net(cfg=[8] * 8, device="cpu",
                                       generator=torch.Generator().manual_seed(seed)),
                               cfg, device="cpu")).to(dev)
        opt = Adam(list(q.parameters()), lr=1e-3)
        shard_model_and_optimizer(q, opt, mesh)
        with batch_reduction(group):
            if not train:
                with torch.no_grad():
                    out = q(shard_batch(x, mesh))
                if not torch.isfinite(out).all():
                    raise RuntimeError("PTQ-KL calibration forward is not finite")
                return q
            loss = TF.cross_entropy(q(shard_batch(x, mesh)), shard_batch(y, mesh))
            loss.backward()
        for p in q.parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            dist.all_reduce(g, group=group)
            p.grad = g / dp
        opt.step()
        if not np.isfinite(float(loss.detach())):
            raise RuntimeError(f"non-finite loss {float(loss.detach())}")
        return q

    q = step(QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), 0)
    # every data replica holds the same observer ranges and BN statistics
    # (slices of the same model rank compared), bit for bit
    checked = 0
    for m in q.modules():
        if isinstance(m, qat_iao.QuantBNFuseConv2d):
            for t in (m.activation_quantizer.min_val, m.activation_quantizer.max_val,
                      m.running_mean):
                reps = _gather_parts(t, group)
                if not all(torch.equal(r, reps[0]) for r in reps[1:]):
                    raise RuntimeError("observer state diverged across replicas")
                checked += len(reps)
    if not checked:
        raise RuntimeError("no quant state found to check")
    step(QuantConfig(a_bits=8, w_bits=8, q_type=1, weight_observer=1), 2)
    step(QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl", pretrained_model=True),
         3, train=False)
    served = _serving_checks(n, dev, mesh, tp) if serving else "serving half not asked"
    if rank == 0:
        print(f"dryrun_multichip: {n} ranks, mesh ({dp}, {tp}): IAO, asymmetric and PTQ-KL "
              f"steps passed, {checked} replica states equal; {served}")
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, *, serving: bool = False) -> None:
    """The JAX package's multi-chip dry run over ``n_devices`` ranks: its
    training half, and with ``serving`` its serving half (module
    docstring); raises on any failure. ``device`` None means CUDA (one
    card a rank)."""
    import socket

    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dryrun_rank, args=(n_devices, port, device, serving), nprocs=n_devices,
                       start_method="spawn")
