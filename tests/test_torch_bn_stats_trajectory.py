"""A 3-step loss trajectory of a narrow NIN (8 channels a layer), IAO
W8A8 with ``bn_fuse``, under the batch-statistics lowerings ``"on"`` (the
bf16 statistics conv) and ``"acc"`` (the statistics from the quantized
conv's accumulator): ``Trainer.train_step`` against the JAX package's
eager ``value_and_grad`` and ``optax.adamw`` on the same batches
(augmented once), free running, in the pattern of
``test_torch_trajectory.py``. The layers themselves:
``test_torch_bn_stats.py``."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.nn import prepare, train_mode
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import data as tdata
from micronet_tpu_torch.train import loop as tloop
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the loss of 3 whole steps, free running: "acc" as test_torch_trajectory.py
# (f32 sums in another order); "on" also rounds the statistics conv's
# gradients to bf16, where a term may land on the neighbouring bf16 value
# (2^-8 relative) and Adam carries it into the next steps; its first step
# (the same weights, a forward only) within 1e-4
TRAJ_RTOL = {"acc": 1e-3, "on": 5e-3}
FIRST_RTOL = 1e-4


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _trainer(model, ds):
    return tloop.Trainer(model, tloop.TrainConfig(batch_size=8, log_every=0, lr=1e-3,
                                                  weight_decay=1e-7),
                         dataset=ds, device="cpu")


@pytest.mark.parametrize("bn_stats", ["on", "acc"])
def test_nin_three_step_loss_trajectory_matches_jax(bn_stats):
    """A narrow NIN (8 channels a layer), IAO W8A8 ``bn_fuse``, 3 whole
    steps of ``Trainer.train_step`` against JAX's eager ``value_and_grad``
    and ``optax.adamw`` on the same batches, free running: the losses
    within ``TRAJ_RTOL``, the first within ``FIRST_RTOL``."""
    kw = dict(bn_fuse=True, bn_stats=bn_stats, act_codes="off")
    jm = jnin.Net(cfg=[8] * 8, rngs=nnx.Rngs(0))
    tm = tnin.Net(cfg=[8] * 8, device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    jm = jtrain(jprepare(jm, JQuantConfig(**kw), method="iao"))
    tm = train_mode(prepare(tm, QuantConfig(**kw), method="iao", device="cpu"))
    tx, ty, ex, ey = tdata._synthetic(24, 8)
    tr = _trainer(tm, tdata.Cifar10(tx, ty, ex, ey, source="synthetic"))
    jopt = nnx.Optimizer(jm, optax.adamw(1e-3, weight_decay=1e-7), wrt=nnx.Param)
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for k in range(3):
        x = tdata.augment_batch(gen, torch.from_numpy(tx[8 * k:8 * k + 8])).numpy()
        y = ty[8 * k:8 * k + 8]

        def loss_fn(m):
            return optax.softmax_cross_entropy_with_integer_labels(
                m(jnp.asarray(x)), jnp.asarray(y)).mean()

        loss, grads = nnx.value_and_grad(loss_fn)(jm)
        jopt.update(jm, grads)
        jl.append(float(loss))
        tl.append(float(tr.train_step(torch.from_numpy(x),
                                      torch.from_numpy(y.astype(np.int64)))[0]))
    np.testing.assert_allclose(tl[0], jl[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL[bn_stats])
    assert tl[-1] != tl[0]
