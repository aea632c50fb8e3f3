"""The deploy end of the port (``infer/deploy.py``, ``cli deploy``) against
the JAX package's ``infer/deploy.py`` on the CPU.

The engine is the JAX deploy test's ``_frozen_engine`` configuration
(``nin.Net(cfg=[8] * 8)``, W8A8, ``bn_fuse``), calibrated in JAX and
carried to the port through ``cnn_state_from_numpy``, as in
``_torch_engine_flow.py``. On the CPU the port's buckets run the engine
eagerly (CUDA graphs are the card's); the card's capture and replay are
held in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 19.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_engine_flow import QUANT_ATOL, _flat, _x, run
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu.infer import build_engine as jbuild_engine
from micronet_tpu.infer import freeze_int as jfreeze
from micronet_tpu.infer import fuse_bn_iao as jfuse
from micronet_tpu.infer.deploy import profile_buckets as jprofile_buckets
from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch import cli
from micronet_tpu_torch.infer import (CompiledEngine, build_engine, deserialize_engine,
                                      freeze_int, fuse_bn_iao, serialize_engine)
from micronet_tpu_torch.infer import deploy
from micronet_tpu_torch.infer.engine import IntLinear
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin
from micronet_tpu_torch.models.resnet import BasicBlock, ResNet
from micronet_tpu_torch.nn import eval_mode, prepare, train_mode
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import save_state

CFG = dict(a_bits=8, w_bits=8, bn_fuse=True)
SHAPE = (32, 32, 3)
K1 = torch.ops.micronet_tpu_torch.int8_matmul_dequant.default


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and its CompiledEngine over buckets 1, 2, 4, 8, and
    the port's from JAX's calibrated state."""
    jq = jprepare(jnin.Net(cfg=[8] * 8, rngs=nnx.Rngs(0)), JQuantConfig(**CFG), method="iao")
    tq = prepare(nin.Net(cfg=[8] * 8, device="cpu"), QuantConfig(**CFG), device="cpu")
    jtrain(jq)
    for i in range(3):
        jq(jnp.asarray(_x(i, (4, *SHAPE))))
    jeval(jq)
    tq.load_state_dict(cnn_state_from_numpy(_flat(jq), tq))
    jeng = jfreeze(jeval(jfuse(jq, JQuantConfig(**CFG))))
    jeval(jeng)
    teng = eval_mode(freeze_int(eval_mode(fuse_bn_iao(eval_mode(tq), QuantConfig(**CFG),
                                                      device="cpu")), device="cpu"))
    return dict(jeng=jeng, jcompiled=jbuild_engine(jeng, profile=(1, 4, 8)), teng=teng,
                tcompiled=build_engine(teng, profile=(1, 4, 8), device="cpu"))


@pytest.mark.parametrize("lo,hi", [(1, 256), (8, 8), (3, 10), (1, 1), (1, 8), (5, 7),
                                   (64, 512), (256, 1024), (3, 1000)])
def test_profile_buckets_match_jax(lo, hi):
    assert deploy.profile_buckets(lo, hi) == jprofile_buckets(lo, hi)


@pytest.mark.parametrize("n", [1, 3, 4, 7, 8, 13, 20])
def test_compiled_engine_matches_eager_and_jax(engines, n):
    """In-bucket, padded and beyond-max (chunked) batches: the port's
    buckets equal its eager engine bit for bit (rows are independent, so
    padding changes no row); against JAX's CompiledEngine within the
    engine-parity tolerance (``QUANT_ATOL``: the first layer's f32 sums
    run in another order, so a code at a .5 boundary may move a step),
    with the same argmax in every row whose top two logits in JAX lie
    further apart than twice the row's difference (a row at an exact tie
    has no argmax to agree on: seen at n = 20, two logits equal in JAX
    and 6e-8 apart in the port)."""
    x = _x(100 + n, (n, *SHAPE))
    got = engines["tcompiled"](torch.from_numpy(x))
    assert tuple(got.shape) == (n, 10)
    assert torch.equal(got, torch.from_numpy(run(engines["teng"], x)))
    ref = np.asarray(engines["jcompiled"](jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=QUANT_ATOL)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * np.abs(got.numpy() - ref).max(-1)
    assert decided.sum() >= n - 1
    assert np.array_equal(got.numpy().argmax(-1)[decided], ref.argmax(-1)[decided])


def test_results_are_copies_cut_from_shared_blocks():
    """A replay's result (``ResultBlocks.take``): a copy, unchanged when
    the source is written again; results of one dtype share a block,
    aligned, until it is full; another dtype, or a result larger than a
    block, gets a block of its own."""
    blocks = deploy.ResultBlocks()
    src = torch.randn(1024, 10)
    per_block = deploy.RESULT_BLOCK_BYTES // src.nbytes
    outs = []
    for _ in range(per_block + 1):
        outs.append((src.clone(), blocks.take(src)))
        src.normal_()
    assert all(torch.equal(want, got) for want, got in outs)
    assert all(got.shape == src.shape and got.is_contiguous() for _, got in outs)
    storages = [got.untyped_storage().data_ptr() for _, got in outs]
    assert len(set(storages[:per_block])) == 1 and storages[-1] != storages[0]
    assert all(got.storage_offset() * 4 % deploy.RESULT_ALIGN_BYTES == 0 for _, got in outs)
    codes = blocks.take(torch.ones(3, 5, dtype=torch.int8))
    assert codes.dtype == torch.int8 and codes.untyped_storage().data_ptr() != storages[-1]
    big = torch.randn(deploy.RESULT_BLOCK_BYTES // 4 + 7)
    assert torch.equal(blocks.take(big), big)


def test_buckets_and_opt_bucket(engines):
    assert engines["tcompiled"].buckets == engines["jcompiled"].buckets == (1, 2, 4, 8)
    assert 3 in build_engine(engines["teng"], profile=(1, 3, 8), device="cpu").buckets


def test_mesh_and_the_default_device_raise(engines, monkeypatch):
    with pytest.raises(TypeError, match="make_mesh"):
        CompiledEngine(engines["teng"], (2,), SHAPE, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(engines["teng"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize_engine(engines["teng"], batch=2)


def _mlp(k, n1, n2):
    """Two symmetric ``IntLinear`` layers (K1 each) over a flat input."""
    rng = np.random.default_rng(0)

    def layer(kin, kout):
        w_q = torch.from_numpy(rng.integers(-127, 128, (kin, kout)).astype(np.int8))
        return IntLinear(w_q, torch.full((kout,), 0.01), 0.05, 0.0, torch.zeros(kout), -128.0,
                         127.0)

    return torch.nn.Sequential(layer(k, n1), torch.nn.ReLU(), layer(n1, n2))


def test_flops_per_bucket(engines):
    """One count per bucket; for two K1 layers it is 2 * sum(M * K * N)."""
    assert set(engines["tcompiled"].flops) == {1, 2, 4, 8}
    mlp = _mlp(24, 16, 8)
    got = CompiledEngine(mlp, (1, 3, 5), (24,), device="cpu").flops
    assert got == {b: float(2 * b * (24 * 16 + 16 * 8)) for b in (1, 3, 5)}


def test_serialize_roundtrip_bytes_and_path(engines, tmp_path):
    """The artifact reproduces the engine bit for bit on the CPU (the JAX
    test asks 1e-5 of its recompiled program; the port's exported graph
    runs the same ATen ops in the same order, so it asks equality),
    through a path and through bytes; its record names the CPU."""
    x = _x(7, (4, *SHAPE))
    ref = run(engines["teng"], x)
    path = tmp_path / "engine.pt2"
    data = serialize_engine(engines["teng"], batch=4, path=str(path), platforms=("cpu",))
    assert len(data) > 1000 and path.read_bytes() == data
    assert deploy.artifact_record(data)["device_type"] == "cpu"
    for src in (str(path), data):
        assert np.array_equal(deserialize_engine(src)(torch.from_numpy(x)).numpy(), ref)


def _with_record(data: bytes, **edits) -> bytes:
    program = torch.export.load(io.BytesIO(data))
    rec = {**deploy.artifact_record(data), **edits}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={deploy.RECORD: json.dumps(rec)})
    return buf.getvalue()


@pytest.mark.parametrize("edits,match", [
    (dict(device_type="cuda", name="NVIDIA H100 80GB HBM3", capability=[9, 0]), "no CUDA card"),
    (dict(device_type="tpu"), "device type 'tpu'"),
])
def test_an_artifact_for_another_device_raises(engines, monkeypatch, edits, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = serialize_engine(engines["teng"], batch=2, platforms=("cpu",))
    with pytest.raises(RuntimeError, match=match):
        deserialize_engine(_with_record(data, **edits))
    with pytest.raises(ValueError, match="one of 'cuda' or 'cpu'"):
        serialize_engine(engines["teng"], batch=2, platforms=("cpu", "cuda"))


def test_resnet_artifact_calls_the_k1_operator():
    """A small ResNet engine's exported graph calls K1's registered
    operator (the fc), and the loaded program equals the engine."""
    torch.manual_seed(0)
    cfg = QuantConfig(**CFG)
    q = train_mode(prepare(ResNet(BasicBlock, [1, 1, 1, 1], device="cpu"), cfg, device="cpu"))
    with torch.no_grad():
        for i in range(3):
            q(torch.from_numpy(_x(20 + i, (2, 16, 16, 3))))
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device="cpu"))
    x = _x(30, (3, 16, 16, 3))
    eng = eval_mode(freeze_int(fused, example_input=torch.from_numpy(x[:1]), device="cpu"))
    runner = deserialize_engine(serialize_engine(eng, batch=3, example_shape=(16, 16, 3),
                                                 platforms=("cpu",)))
    assert [n.target for n in runner.program.graph.nodes].count(K1) == 1
    assert np.array_equal(runner(torch.from_numpy(x)).numpy(), run(eng, x))


def test_cli_deploy_writes_an_artifact_equal_to_the_engine(tmp_path, capsys):
    """checkpoint -> ``cli deploy`` -> the artifact equals the engine built
    from the same checkpoint."""
    cfg = QuantConfig(**CFG)
    q = train_mode(prepare(nin.Net(cfg=[8] * 8, device="cpu"), cfg, device="cpu"))
    with torch.no_grad():
        for i in range(2):
            q(torch.from_numpy(_x(40 + i, (4, *SHAPE))))
    ckpt, out = tmp_path / "iao.npz", tmp_path / "deploy" / "engine.pt2"
    save_state(str(ckpt), q)
    widths = ",".join(["8"] * 8)
    assert cli.main(["deploy", "--device", "cpu", "--model_type", "0", "--cfg", widths,
                     "--bn_fuse", "--model", str(ckpt), "--save", str(out), "--batch",
                     "4"]) == 0
    assert "serialized engine" in capsys.readouterr().out
    fused = eval_mode(fuse_bn_iao(eval_mode(q), cfg, device="cpu"))
    eng = eval_mode(freeze_int(fused, example_input=torch.zeros((1, *SHAPE)), device="cpu"))
    x = _x(50, (4, *SHAPE))
    assert np.array_equal(deserialize_engine(str(out))(torch.from_numpy(x)).numpy(), run(eng, x))
