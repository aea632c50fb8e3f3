"""Rank workers of ``tests/test_torch_sequence.py``, ``test_torch_moe_ep.py``,
``test_torch_pipeline.py`` and ``test_torch_parallel_serving.py``: gloo
processes on the CPU, started by ``torch.multiprocessing``. They import
torch, numpy and the port, never JAX. Each reads its inputs (made by the
test from a numpy seed, JAX's weights among them) from ``<dir>/in.npz``,
runs its checks (raising on a failure) and rank 0 writes what the test
compares with JAX into ``<dir>/out.npz``. Every rank arms
``faulthandler`` and the parent joins with a deadline, so a rank left
waiting on an exchange fails the test with its traceback instead of
hanging it.
"""

import copy
import faulthandler
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from micronet_tpu_torch.interop import (cnn_state_from_numpy, llama_state_from_numpy,  # noqa: E402
                                        tiny_decoder_state_from_numpy)
from micronet_tpu_torch.parallel import initialize, shard_state  # noqa: E402
from micronet_tpu_torch.parallel.sharding import axis_mesh, make_mesh  # noqa: E402

RANK_TIMEOUT = 240  # seconds a rank may run before it dumps its stacks and exits


def spawn(fn, world, out: Path, timeout: float = RANK_TIMEOUT + 30):
    """``fn(rank, world, port, out)`` in ``world`` gloo processes; raises if
    one fails or the world outlives ``timeout`` seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(fn, args=(world, port, out), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{fn.__name__}: {world} ranks still running after {timeout} s")


def _init(rank, world, port):
    faulthandler.dump_traceback_later(RANK_TIMEOUT, exit=True)
    torch.set_num_threads(1)
    initialize(f"tcp://localhost:{port}", world, rank, device="cpu")


def _inputs(out: Path):
    with np.load(out / "in.npz") as z:
        return {k: z[k] for k in z.files}


def _save(out: Path, **arrays):
    if dist.get_rank() == 0:
        np.savez(out / "out.npz", **{k: np.asarray(v) for k, v in arrays.items()})
    dist.barrier()
    dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(z, prefix):
    """JAX's flat state saved under ``prefix/a/b`` keys, as {(a, b): array}."""
    return {tuple(k[len(prefix) + 1:].split("/")): z[k] for k in z if k.startswith(prefix + "/")}


# ---------------------------------------------------------------- ring attention

def _ring_case(q, k, v, tgt, mesh, causal, balanced):
    from micronet_tpu_torch.parallel import ring_attention

    q, k, v = (a.clone().requires_grad_() for a in (q, k, v))
    y = ring_attention(q, k, v, mesh, causal=causal, balanced=balanced)
    torch.mean((y - tgt) ** 2).backward()
    return [y.detach(), q.grad, k.grad, v.grad]


RING_CASES = {"zigzag": (True, True), "contiguous": (True, False), "full": (False, True)}


def sequence_worker(rank, world, port, out: Path):
    """Ring attention, each schedule's values and gradients; an odd local
    length (the contiguous fallback); the zigzag maps are permutations."""
    from micronet_tpu_torch.parallel.sequence import _zigzag_maps

    _init(rank, world, port)
    z = _inputs(out)
    mesh = axis_mesh("seq", device="cpu")
    q, k, v, tgt = (_t(z[n]) for n in ("q", "k", "v", "tgt"))
    res = {}
    for name, (causal, balanced) in RING_CASES.items():
        for i, a in enumerate(_ring_case(q, k, v, tgt, mesh, causal, balanced)):
            res[f"{name}_{i}"] = a
    t_odd = world * 3
    for i, a in enumerate(_ring_case(q[:t_odd], k[:t_odd], v[:t_odd], tgt[:t_odd], mesh,
                                     True, True)):
        res[f"odd_{i}"] = a
    t_e, t_o = _zigzag_maps(world)
    assert sorted(t_e) == sorted(t_o) == list(range(world)), (t_e, t_o)
    res["maps"] = torch.tensor([t_e, t_o])
    _save(out, **res)


# ---------------------------------------------------------------- expert parallelism

def _moe_params(z, prefix=""):
    from micronet_tpu_torch.parallel import MoEParams

    return MoEParams(*(_t(z[prefix + n]) for n in ("router", "w_up", "w_down")))


def _moe_grads(fn, params, x, tgt):
    import dataclasses

    p = dataclasses.replace(params, **{n: getattr(params, n).clone().requires_grad_()
                                       for n in ("router", "w_up", "w_down")})
    x = x.clone().requires_grad_()
    y = fn(p, x)
    torch.mean((y - tgt) ** 2).backward()
    return [y.detach(), p.router.grad, p.w_up.grad, p.w_down.grad, x.grad]


def _moe_decoder(z, kw, ep_mesh=None):
    from micronet_tpu_torch.models.tiny_decoder import TinyDecoder, quantize_decoder

    m = quantize_decoder(TinyDecoder(**kw, device="cpu"), group=8)
    if ep_mesh is not None:
        for blk in m.blocks:
            blk.moe.use_ep(ep_mesh)
    m.load_state_dict(tiny_decoder_state_from_numpy(_flat(z, "dec"), m))
    return m


def moe_worker(rank, world, port, out: Path):
    """``moe_apply_ep`` and ``moe_apply_ep_a2a`` (top-1 and top-2, float
    and int8 experts, the whole E or the rank's experts): values and
    gradients; the EP MoE decoder (prefill, a decode step, greedy tokens)
    and its ``state_dict`` round trips."""
    from micronet_tpu_torch.parallel import moe_apply_ep, moe_apply_ep_a2a, quantize_moe
    from micronet_tpu_torch.parallel.sharding import axis_rank

    _init(rank, world, port)
    z = _inputs(out)
    mesh = axis_mesh("expert", device="cpu")
    params, x, tgt = _moe_params(z), _t(z["x"]), _t(z["tgt"])
    cf = float(z["cf"])
    res = {}
    cases = {"ep": lambda p, xi: moe_apply_ep(p, xi, mesh, capacity_factor=cf)}
    for k in (1, 2):
        cases[f"a2a{k}"] = (lambda kk: lambda p, xi: moe_apply_ep_a2a(
            p, xi, mesh, capacity_factor=cf, top_k=kk))(k)
    for name, fn in cases.items():
        for i, a in enumerate(_moe_grads(fn, params, x, tgt)):
            res[f"{name}_{i}"] = a
    q = quantize_moe(params)
    with torch.no_grad():
        res["ep_int8"] = moe_apply_ep(q, x, mesh, capacity_factor=cf)
        res["a2a_int8"] = moe_apply_ep_a2a(q, x, mesh, capacity_factor=cf, top_k=2)
        # the rank's experts only: the same result, gradients local
        import dataclasses
        e = params.router.shape[-1] // world
        r = axis_rank(mesh, "expert")
        local = dataclasses.replace(q, **{n: getattr(q, n)[r * e:(r + 1) * e] for n in (
            "w_up", "w_down", "up_scale", "down_scale")})
        torch.testing.assert_close(moe_apply_ep(local, x, mesh, capacity_factor=cf),
                                   res["ep_int8"], rtol=0, atol=0)

    kw = {k: int(v) for k, v in zip(("vocab", "dim", "heads", "depth", "mlp_dim", "max_seq",
                                     "moe_experts"), z["dec_kw"])}
    dense, ep = _moe_decoder(z, kw), _moe_decoder(z, kw, mesh)
    assert ep.blocks[0].moe.w_up.shape[0] == kw["moe_experts"] // world
    toks = torch.arange(6)
    with torch.no_grad():
        le, ce = ep.forward(toks, ep.init_cache(), 0)
        l1, _ = ep.forward(torch.tensor([3]), ce, 6)
        res["dec_prefill"], res["dec_step"] = le, l1
        res["dec_tokens"] = ep.generate(toks, 6)
        res["dec_tokens_dense"] = dense.generate(toks, 6)
        # the state_dict round trip keeps the EP dispatch; a whole-E (dense)
        # state loads into an EP model as its slice
        for sd in (ep.state_dict(), dense.state_dict()):
            again = _moe_decoder(z, kw, mesh)
            again.load_state_dict(sd)
            assert again.blocks[0].moe.ep_mesh is mesh
            torch.testing.assert_close(again.forward(toks, again.init_cache(), 0)[0], le,
                                       rtol=0, atol=0)
    _save(out, **res)


# ---------------------------------------------------------------- pipeline

def _mlp_stage(params, h):
    return torch.relu(h @ params["w"] + params["b"])


def _iao_stage(flat, c, seed=0):
    from micronet_tpu_torch.models.nin import ConvBNReLU
    from micronet_tpu_torch.nn import prepare, train_mode
    from micronet_tpu_torch.quant.config import QuantConfig

    m = train_mode(prepare(ConvBNReLU(c, c, 3, stride=1, padding=1, device="cpu",
                                      generator=torch.Generator().manual_seed(seed)),
                           QuantConfig(a_bits=8, w_bits=8, bn_fuse=True), device="cpu"))
    m.load_state_dict(cnn_state_from_numpy(flat, m))
    return m


def pipeline_worker(rank, world, port, out: Path):
    """``pipeline_apply`` (the JAX test's MLP stage: outputs, every stage's
    gradients and the input's) and ``pipeline_apply_stateful`` over IAO
    ``bn_fuse`` conv stages (outputs, gradients, the observers and BN
    statistics), each also with the rank's stage row only."""
    from micronet_tpu_torch.graft_entry import _stage_fn
    from micronet_tpu_torch.parallel import (pipeline_apply, pipeline_apply_stateful,
                                             stack_stage_params)

    _init(rank, world, port)
    z = _inputs(out)
    mesh = axis_mesh("stage", device="cpu")
    res = {}
    stacked = {n: _t(z[n]).requires_grad_() for n in ("w", "b")}
    x, tgt = _t(z["x"]).requires_grad_(), _t(z["tgt"])
    y = pipeline_apply(_mlp_stage, stacked, x, mesh)
    torch.mean((y - tgt) ** 2).backward()
    res.update(mlp_y=y.detach(), mlp_gw=stacked["w"].grad, mlp_gb=stacked["b"].grad,
               mlp_gx=x.grad)
    row = {n: _t(z[n])[rank:rank + 1].requires_grad_() for n in ("w", "b")}
    y_row = pipeline_apply(_mlp_stage, row, _t(z["x"]), mesh)
    torch.mean((y_row - tgt) ** 2).backward()
    torch.testing.assert_close(y_row.detach(), res["mlp_y"], rtol=0, atol=0)
    torch.testing.assert_close(row["w"].grad[0], stacked["w"].grad[rank], rtol=0, atol=0)

    c = int(z["c"])
    stages = [_iao_stage(_flat(z, f"stage{s}"), c) for s in range(world)]
    params = stack_stage_params([{k: v.detach() for k, v in m.named_parameters()}
                                 for m in stages])
    params = {k: v.requires_grad_() for k, v in params.items()}
    state = stack_stage_params([{k: v.detach() for k, v in m.named_buffers()}
                                for m in stages])
    px = _t(z["px"])
    fn = _stage_fn(stages[0])
    out_pp, new = pipeline_apply_stateful(fn, params, state, px, mesh)
    torch.mean(out_pp ** 2).backward()
    res["pp_y"] = out_pp.detach()
    res.update({f"pp_grad/{k}": v.grad for k, v in params.items()})
    res.update({f"pp_state/{k}": v for k, v in new.items()})
    p_row = {k: v.detach()[rank:rank + 1].requires_grad_() for k, v in params.items()}
    s_row = {k: v[rank:rank + 1] for k, v in state.items()}
    out_row, new_row = pipeline_apply_stateful(fn, p_row, s_row, px, mesh)
    torch.testing.assert_close(out_row.detach(), res["pp_y"], rtol=0, atol=0)
    for k, v in new_row.items():
        torch.testing.assert_close(v[0], new[k][rank], rtol=0, atol=0)
    _save(out, **res)


# ---------------------------------------------------------------- tensor-parallel serving

def _llama(z):
    from micronet_tpu_torch.models.llama import Llama, LlamaConfig, quantize_llama

    cfg = LlamaConfig(*(int(v) for v in z["llama_cfg"][:7]), rope_theta=10000.0)
    m = quantize_llama(Llama(cfg, device="cpu"), group=int(z["llama_group"]))
    m.load_state_dict(llama_state_from_numpy(_flat(z, "llama"), cfg))
    return m


def _tp_decoder(z):
    from micronet_tpu_torch.models.tiny_decoder import TinyDecoder, quantize_decoder

    kw = {k: int(v) for k, v in zip(("vocab", "dim", "heads", "depth", "mlp_dim", "max_seq"),
                                     z["dec_kw"])}
    m = quantize_decoder(TinyDecoder(**kw, device="cpu"), group=8)
    m.load_state_dict(tiny_decoder_state_from_numpy(_flat(z, "dec"), m))
    return m


def serving_worker(rank, world, port, out: Path):
    """The W4 Llama tensor-parallel over ``model``: ``forward``,
    ``decode_batch`` and ``decode_batch_paged`` (active mask, one page);
    the W4 TinyDecoder tensor-parallel, its ``ServeLoop`` tokens equal
    the unsharded loop's; the sequence-parallel prefill (logits, caches,
    decode steps from either cache)."""
    from micronet_tpu_torch.models.tiny_decoder import TinyDecoder, quantize_decoder
    from micronet_tpu_torch.quant.weight_only import WOLinear
    from micronet_tpu_torch.serve import Request, ServeLoop

    _init(rank, world, port)
    z = _inputs(out)
    mesh = make_mesh(1, world, device="cpu")
    res = {}
    lm = _llama(z)
    sh = shard_state(copy.deepcopy(lm), mesh)
    blk = sh.blocks[0]
    assert isinstance(blk.wqkv, WOLinear) and blk.wqkv.packed.shape[1] * world == \
        lm.blocks[0].wqkv.packed.shape[1] == blk.wqkv.split_cols  # K3 splits as unsharded
    assert blk.attn_norm.weight.shape == lm.blocks[0].attn_norm.weight.shape
    toks = torch.tensor([1, 2, 3])
    res["llama_prefill"], caches = sh.forward(toks, sh.init_cache(), 0)
    res["llama_step"], _ = sh.forward(torch.tensor([5]), caches, 3)
    btoks = torch.tensor([[1], [2]])
    boffs = torch.zeros((2,), dtype=torch.int32)
    res["llama_batch"], bc = sh.decode_batch(btoks, sh.init_cache_batch(2), boffs)
    res["llama_batch2"], _ = sh.decode_batch(btoks, bc, boffs + 1)
    pc = sh.init_paged_cache(slots=2, page_size=4, num_pages=9)
    top0 = int(pc[0].free_top)
    res["llama_paged"], pc2 = sh.decode_batch_paged(btoks, pc, boffs, torch.tensor([True, False]))
    res["llama_paged_lengths"] = pc2[0].lengths
    res["llama_paged_pages"] = torch.tensor(top0 - int(pc2[0].free_top))

    dec = _tp_decoder(z)
    dsh = shard_state(copy.deepcopy(dec), mesh)
    res["dec_prefill"], _ = dsh.forward(torch.arange(5), dsh.init_cache(), 0)
    loops = []
    for model in (dec, dsh):
        loop = ServeLoop(model, 2, device="cpu")
        for rid, (n, new) in enumerate(((3, 5), (6, 4), (2, 6))):
            loop.submit(Request(rid, list(range(1, n + 1)), new))
        loops.append({r: q.output for r, q in loop.run().items()})
    assert loops[0] == loops[1], loops

    sp_mesh = axis_mesh("seq", device="cpu")
    kw = {k: int(v) for k, v in zip(("vocab", "dim", "heads", "depth", "mlp_dim", "max_seq"),
                                     z["sp_kw"])}
    spd = quantize_decoder(TinyDecoder(**kw, device="cpu"), group=8)
    spd.load_state_dict(tiny_decoder_state_from_numpy(_flat(z, "sp"), spd))
    sp_toks = _t(z["sp_toks"])
    n_tok = int(sp_toks.shape[0])
    with torch.no_grad():
        res["sp_prefill"], c_sp = spd.prefill_sp(sp_toks, spd.init_cache(), sp_mesh)
        res["sp_dense"], c_d = spd.forward(sp_toks, spd.init_cache(), 0)
        for i, (a, b) in enumerate(zip(c_sp, c_d)):
            for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (i, f)
            res[f"sp_k_codes{i}"] = a.k_codes.clone()  # decode appends in place
        # dense decode steps from either cache: the same bits
        for step, tok in enumerate((5, 7, 11)):
            ls, c_sp = spd.forward(torch.tensor([tok]), c_sp, n_tok + step)
            l2, c_d = spd.forward(torch.tensor([tok]), c_d, n_tok + step)
            assert torch.equal(ls, l2), step
            res[f"sp_step{step}"] = ls
    _save(out, **res)
