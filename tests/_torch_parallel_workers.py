"""Rank workers of ``tests/test_torch_parallel*.py``: two gloo processes on
the CPU, started by ``torch.multiprocessing``. They import torch, numpy,
the port and ``chip_smoke.py`` (whose block-by-block check of a sharded
step, phase 21's, they run at small widths); never JAX. Each worker runs
its checks and raises on a failure; rank 0 writes the arrays the test
compares with JAX into ``out``.
"""

import copy
import importlib.util
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as TF

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from micronet_tpu_torch.interop import cnn_state_from_numpy  # noqa: E402
from micronet_tpu_torch.models import nin, nin_gc  # noqa: E402
from micronet_tpu_torch.nn import prepare, qat_iao, train_mode  # noqa: E402
from micronet_tpu_torch.parallel import (dp_shard_map_step, initialize, make_mesh,  # noqa: E402
                                         shard_batch, shard_state)
from micronet_tpu_torch.parallel.distributed import (_gather_parts, batch_reduction,  # noqa: E402
                                                     gather_flat)
from micronet_tpu_torch.quant.calibrate import kl_threshold  # noqa: E402
from micronet_tpu_torch.quant.config import QuantConfig  # noqa: E402
from micronet_tpu_torch.train import TrainConfig, Trainer  # noqa: E402

WORLD = 2
GRAD_RTOL = 1e-5  # tensor-parallel gradients against the unsharded ones, x max|g|


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spawn(fn, *args):
    """``fn(rank, WORLD, port, *args)`` in two gloo processes; raises if
    one fails."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(fn, args=(WORLD, port, *args), nprocs=WORLD, start_method="spawn")


def _init(rank, world, port):
    torch.set_num_threads(1)
    initialize(f"tcp://localhost:{port}", world, rank, device="cpu")


def _same_on_every_rank(t, what):
    parts = _gather_parts(t.contiguous(), dist.group.WORLD)
    assert all(torch.equal(p, parts[0]) for p in parts[1:]), f"{what} differs across ranks"


def _nin(flat, cfg):
    m = nin.Net(cfg=[8] * 8, device="cpu")
    m.load_state_dict(cnn_state_from_numpy({(k,): v for k, v in flat.items()}))
    return train_mode(prepare(m, cfg, device="cpu"))


def _nin_gc(cfg, seed=0):
    m = nin_gc.Net(cfg=[32] * 8, device="cpu", generator=torch.Generator().manual_seed(seed))
    return train_mode(m if cfg is None else prepare(m, cfg, device="cpu"))


def _tp_float_grads(mesh, x, y):
    """Float NIN-GC's whole-model gradients, tensor-parallel against
    unsharded: each rank's slice within ``GRAD_RTOL`` (a gather whose
    backward summed over the ranks would double them)."""
    from micronet_tpu_torch.parallel.sharding import _sharded

    ref = _nin_gc(None)
    tp = shard_state(copy.deepcopy(ref), mesh)
    for m in (ref, tp):
        TF.cross_entropy(m(x), y).backward()
    gmax = max(p.grad.abs().max().item() for p in ref.parameters())
    names = {id(mm): n for n, mm in tp.named_modules()}
    sliced = {f"{names[id(m)]}.{path}": dim for m, path, dim, _ in _sharded(tp)}
    rank = dist.get_rank()
    for (name, p), q in zip(ref.named_parameters(), tp.parameters()):
        g = p.grad
        if name in sliced:
            k = q.shape[sliced[name]]
            g = g.narrow(sliced[name], rank * k, k)
        torch.testing.assert_close(q.grad, g, rtol=0, atol=GRAD_RTOL * gmax, msg=name)
    return len(sliced)


def _tp_transposed(mesh):
    """The out-channel rule on each layout (a transposed conv's kernel on
    dim 1), and an IAO conv, transposed conv (per-layer weight quantizer:
    its range reduced over the model axis) and 1x1 conv in training mode,
    tensor-parallel against unsharded: outputs and gradients within
    ``GRAD_RTOL``."""
    from micronet_tpu_torch.nn import modules as M
    from micronet_tpu_torch.nn import qat_dorefa
    from micronet_tpu_torch.parallel import channel_sharding_for

    gen = torch.Generator().manual_seed(4)
    net = M.Sequential(M.Conv2d(6, 16, 3, padding=1, device="cpu", generator=gen),
                       M.ConvTranspose2d(16, 8, 4, stride=2, padding=1, device="cpu",
                                         generator=gen),
                       M.Conv2d(8, 4, 1, device="cpu", generator=gen))
    ref = train_mode(prepare(net, QuantConfig(), device="cpu"))
    c, t = ref.layers[0], ref.layers[1]
    lin = M.Linear(6, 4, device="cpu")
    dq = qat_dorefa.QuantConv2d(6, 4, 1, cfg=QuantConfig(), device="cpu")
    assert [channel_sharding_for(m, n, mesh) for m, n in (
        (c, "weight"), (c, "weight_quantizer.min_val"), (t, "weight"), (t, "bias"),
        (t, "weight_quantizer.min_val"), (lin, "weight"), (dq, "weight"))] == [
        0, 0, 1, 0, None, 1, None]
    tp = shard_state(copy.deepcopy(ref), mesh)
    assert tp.layers[1].weight_quantizer.shard_group is not None
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 6, 8, 8))
                         .astype(np.float32))
    outs = [m(x) for m in (ref, tp)]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    for o in outs:
        o.square().sum().backward()
    gmax = max(p.grad.abs().max().item() for p in ref.parameters())
    rank = dist.get_rank()
    for (name, p), q in zip(ref.named_parameters(), tp.parameters()):
        g = p.grad
        for d in range(g.dim()):
            if q.shape[d] != g.shape[d]:
                g = g.narrow(d, rank * q.shape[d], q.shape[d])
        torch.testing.assert_close(q.grad, g, rtol=0, atol=GRAD_RTOL * gmax, msg=name)


def _entropy_stream(group_rows):
    """An entropy quantizer fed four batches: whole, or each rank its rows
    under a batch reduction over the world."""
    fq = train_mode(qat_iao.FakeQuantizer(8, observer="entropy", device="cpu"))
    rng = np.random.default_rng(0)
    for i in range(4):
        x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32) * (1.0 + i))
        if group_rows:
            with batch_reduction(dist.group.WORLD):
                fq.observe(x.chunk(WORLD)[dist.get_rank()])
        else:
            fq.observe(x)
    return fq.ent_counts.clone(), float(fq.ent_absmax)


def train_worker(rank, world, port, out: Path):
    """The training checks (``test_data_and_tensor_parallel_training``)."""
    _init(rank, world, port)
    cs = chip_smoke()
    dp_mesh, tp_mesh = make_mesh(2, 1, device="cpu"), make_mesh(1, 2, device="cpu")
    for shape in ((2, 2), (1, 1)):  # a world too small, and one too large
        try:
            make_mesh(*shape, device="cpu")
        except ValueError:
            continue
        raise AssertionError(f"make_mesh{shape} in a world of 2 did not raise")
    with np.load(out / "inputs.npz") as z:
        flat = {k[len("w/"):]: z[k] for k in z.files if k.startswith("w/")}
        x_nhwc, y = torch.from_numpy(z["x"]), torch.from_numpy(z["y"])
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    results = {}
    bn_fuse = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)

    # DP and TP steps against one process on the whole batch, block by block
    ref = _nin(flat, bn_fuse)
    results["dp_step"] = cs.sharded_step_vs_single(ref, copy.deepcopy(ref), dp_mesh, x, y)
    for label, cfg in (("tp_step_iao", bn_fuse), ("tp_step_float", None),
                       ("tp_step_asym", QuantConfig(a_bits=8, w_bits=8, q_type=1,
                                                    weight_observer=1))):
        ref = _nin_gc(cfg)
        tp = shard_state(copy.deepcopy(ref), tp_mesh)
        results[label] = cs.sharded_step_vs_single(ref, tp, tp_mesh, x, y, rtol=GRAD_RTOL)
    results["tp_sliced_tensors"] = _tp_float_grads(tp_mesh, x_nhwc, y)
    _tp_transposed(tp_mesh)

    # the DP forward of JAX's weights (against JAX's make_mesh(data=2))
    q = _nin(flat, bn_fuse)
    with batch_reduction(dp_mesh.get_group("data")):
        y_dp = q(shard_batch(x_nhwc, dp_mesh))
    y_dp = torch.cat(_gather_parts(y_dp.detach(), dp_mesh.get_group("data")))
    scales = [m.weight_quantizer.scale.reshape(-1).numpy() for m in q.modules()
              if isinstance(m, qat_iao.QuantBNFuseConv2d)]
    _same_on_every_rank(y_dp, "the DP forward")

    # one Trainer step each way: the replicas hold the same state bit for bit
    trainers = {}
    for label, mesh in (("single", None), ("dp", dp_mesh), ("tp", tp_mesh)):
        tr = Trainer(_nin(flat, bn_fuse), TrainConfig(batch_size=16, log_every=0),
                     dataset=object(), mesh=mesh, device="cpu")
        trainers[label] = (tr, tr.train_step(x_nhwc, y))
    dp_model = trainers["dp"][0].model
    for name, t in list(dp_model.named_parameters()) + list(dp_model.named_buffers()):
        _same_on_every_rank(t.detach(), f"DP replica {name}")
    # a code may round the other way at an edge (the moments are summed in
    # another order), moving the loss by a little
    losses = [float(trainers[k][1][0]) for k in trainers]
    assert max(losses) - min(losses) <= 1e-3 * abs(losses[0]), losses

    # the entropy observer: the sharded stream's histogram and threshold
    c1, m1 = _entropy_stream(False)
    c2, m2 = _entropy_stream(True)
    assert m1 == m2
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), atol=1e-3)
    assert kl_threshold(c1.double().numpy(), m1) == kl_threshold(c2.double().numpy(), m2)
    # the percentile observer: the global k-th |x| exactly
    xs = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 300)).astype(np.float32))
    fh = [train_mode(qat_iao.FakeQuantizer(8, observer="histogram", device="cpu"))
          for _ in range(2)]
    fh[0].observe(xs)
    with batch_reduction(dist.group.WORLD):
        fh[1].observe(xs.chunk(WORLD)[rank])
    assert torch.equal(fh[0].max_val, fh[1].max_val)
    assert gather_flat(xs.chunk(WORLD)[rank], dist.group.WORLD).numel() == xs.numel()

    # dp_shard_map_step: a rank-local outlier widens the merged grid
    ptq = QuantConfig(a_bits=8, w_bits=8, ptq=True, ptq_observer="kl")
    xo = x_nhwc.clone()
    xo[0] *= 8.0
    qs, qb = _nin(flat, ptq), _nin(flat, ptq)
    step = dp_shard_map_step(qs, dp_mesh, lambda lg, yy: TF.cross_entropy(lg, yy))
    step(xo, y)
    with torch.no_grad():
        qb(xo)
    fa, fb = (next(m.activation_quantizer for m in mm.modules()
                   if isinstance(m, qat_iao.QuantConv2d)) for mm in (qs, qb))
    assert float(fa.ent_absmax) == float(fb.ent_absmax)
    ca, cb = fa.ent_counts.numpy(), fb.ent_counts.numpy()
    pa = (ca / ca.sum()).reshape(256, -1).sum(1)
    pb = (cb / cb.sum()).reshape(256, -1).sum(1)
    np.testing.assert_allclose(pa, pb, atol=5e-3)
    np.testing.assert_allclose(kl_threshold(ca.astype(np.float64), float(fa.ent_absmax)),
                               kl_threshold(cb.astype(np.float64), float(fb.ent_absmax)),
                               rtol=0.05)

    if rank == 0:
        np.savez(out / "port.npz", y_dp=y_dp.numpy(),
                 **{f"scale{i}": s for i, s in enumerate(scales)},
                 summary=np.frombuffer(repr(results).encode(), dtype=np.uint8))
    dist.destroy_process_group()


# ------------------------------------------------------------------ engines

def _engine(kind):
    """A small frozen engine from seeded weights: ResNet W8A8 (K1 in its
    fc, residual adds) or NIN-GC W4A4 (grouped, nibble-packed)."""
    from micronet_tpu_torch.infer import freeze_int, fuse_bn_iao
    from micronet_tpu_torch.models.resnet import BasicBlock, ResNet
    from micronet_tpu_torch.nn import eval_mode

    gen = torch.Generator().manual_seed(5)
    if kind == "resnet":
        model, cfg = ResNet(BasicBlock, [1, 1, 1, 1], device="cpu", generator=gen), QuantConfig(
            a_bits=8, w_bits=8, bn_fuse=True)
    else:
        model = nin_gc.Net(cfg=[32] * 8, device="cpu", generator=gen)
        cfg = QuantConfig(a_bits=4, w_bits=4, bn_fuse=True)
    q = train_mode(prepare(model, cfg, device="cpu"))
    with torch.no_grad():
        for _ in range(3):
            q(torch.randn((8, 32, 32, 3), generator=gen))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device="cpu"))
    return eval_mode(freeze_int(fused, example_input=torch.zeros(1, 32, 32, 3), device="cpu"))


def engine_worker(rank, world, port, out: Path):
    """The engine checks (``test_sharded_engine_equals_single_process``):
    ``build_engine(mesh=)`` at dp = 2 bit for bit and at tp = 2 within 1e-5
    of the single-process engine, at padded, exact and chunked requests."""
    from micronet_tpu_torch.infer import build_engine
    from micronet_tpu_torch.infer.engine import IntConv2d, IntLinear
    from micronet_tpu_torch.ops import int_matmul as i8

    _init(rank, world, port)
    meshes = {"dp": make_mesh(2, 1, device="cpu"), "tp": make_mesh(1, 2, device="cpu")}
    gen = torch.Generator().manual_seed(9)
    xs = {n: torch.randn((n, 32, 32, 3), generator=gen) for n in (2, 3, 8, 11)}
    worst = {}
    for kind in ("resnet", "nin_gc"):
        single = _engine(kind)
        with torch.no_grad():
            refs = {n: single(x) for n, x in xs.items()}
        for label, mesh in meshes.items():
            eng = _engine(kind)
            ce = build_engine(eng, profile=(1, 4, 8), example_shape=(32, 32, 3), mesh=mesh,
                              device="cpu")
            assert all(b % (2 if label == "dp" else 1) == 0 for b in ce.buckets), ce.buckets
            if label == "tp":
                sharded = [m for m in eng.modules() if hasattr(m, "_channel_parallel")]
                assert any(isinstance(m, IntConv2d) for m in sharded)
                if kind == "resnet":
                    assert any(isinstance(m, IntLinear) for m in sharded)
                else:
                    assert any(getattr(m, "w_packed", False) and m.groups > 1 for m in sharded)
            for n, x in xs.items():
                got = ce(x)
                _same_on_every_rank(got, f"{kind} {label} engine at {n}")
                ref = refs[n]
                if label == "dp":
                    assert torch.equal(got, ref), f"{kind} dp engine at {n}"
                else:
                    tol = 1e-5 * max(1.0, ref.abs().max().item())
                    diff = (got - ref).abs().max().item()
                    assert diff <= tol, f"{kind} tp engine at {n}: {diff} > {tol}"
                    worst[kind] = max(worst.get(kind, 0.0), diff)
    assert i8.int8_matmul_dequant.launches == 0  # CPU tensors run the twin
    if rank == 0:
        np.savez(out / "engine.npz", **{k: np.float64(v) for k, v in worst.items()})
    dist.destroy_process_group()
