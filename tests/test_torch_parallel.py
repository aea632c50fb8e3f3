"""Data and tensor parallelism of the port (``parallel/distributed.py``,
``parallel/sharding.py``, ``Trainer(mesh=)``) in two gloo processes on the
CPU (``tests/_torch_parallel_workers.py``, which import only the port),
against the port's single process and against the JAX package's
``make_mesh(data=2)`` on the conftest's CPU devices.
"""

import numpy as np
import torch
import torch.distributed as dist
from flax import nnx

import jax
from _torch_parallel_workers import spawn, train_worker
from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import qat_iao as jqat
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.parallel import make_mesh as jmake_mesh
from micronet_tpu.parallel import shard_batch as jshard_batch
from micronet_tpu.parallel import shard_model_and_optimizer as jshard
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.parallel import initialize

# tests/test_cli_native.py::test_data_parallel_observer_consistency's
# bounds: the reduction order differs across shards, and a statistic an
# ulp off moves a rounding boundary
OUT_ATOL, SCALE_RTOL = 2e-2, 1e-3


def test_initialize_is_a_no_op_alone(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert initialize(world_size=1, device="cpu") is False
    assert not dist.is_initialized()


def _jax_nin():
    return jnin.Net(cfg=[8] * 8, rngs=nnx.Rngs(0))


def test_data_and_tensor_parallel_training(tmp_path):
    """In two ranks (each check in ``train_worker``): the DP step (2 x 8
    rows) and the TP step (out channels halved; IAO, float and asymmetric
    NIN-GC) against one process on the batch of 16, block by block, the TP
    gradients within 1e-5; float TP gradients of the whole model; the
    out-channel rule on each layout and a TP transposed conv; one
    Trainer step each way, the DP replicas equal bit for bit; the entropy
    observer's sharded stream; the percentile's global k-th value;
    ``dp_shard_map_step`` with a rank-local outlier; ``make_mesh`` refusing
    a world of another size. Here: the port's DP forward against JAX's
    ``make_mesh(data=2)``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16)
    flat = {".".join(map(str, k)): np.asarray(v[...])
            for k, v in nnx.state(_jax_nin()).flat_state()}
    np.savez(tmp_path / "inputs.npz", x=x, y=y, **{f"w/{k}": v for k, v in flat.items()})
    spawn(train_worker, tmp_path)

    cfg = JQuantConfig(a_bits=8, w_bits=8, bn_fuse=True)
    q = jprepare(_jax_nin(), cfg, method="iao")
    jtrain(q)
    mesh = jmake_mesh(data=2, model=1)
    jshard(q, None, mesh)
    with mesh:
        y_jax = nnx.jit(lambda m, a: m(a))(q, jshard_batch(jax.numpy.asarray(x), mesh))
    scales = [np.asarray(m.weight_quantizer.scale[...]).reshape(-1)
              for _, m in nnx.iter_modules(q) if isinstance(m, jqat.QuantBNFuseConv2d)]
    with np.load(tmp_path / "port.npz") as port:
        np.testing.assert_allclose(port["y_dp"], np.asarray(y_jax), atol=OUT_ATOL)
        assert len(scales) == 9
        for i, s in enumerate(scales):
            np.testing.assert_allclose(port[f"scale{i}"], s, rtol=SCALE_RTOL)
