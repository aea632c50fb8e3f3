"""A 3-step loss trajectory of ``Trainer.train_step`` against the JAX
package's eager steps (``nnx.value_and_grad`` and ``optax.adamw``, never a
jitted step), the same batches augmented once, on LeNet float and IAO
with BN folding at batch 8: the losses within 1e-3 relative, free running
(a quantized net's codes may move at .5 edges from the first step on)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from micronet_tpu.models import LeNet as JLeNet
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models.lenet import LeNet
from micronet_tpu_torch.nn import prepare, train_mode
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import data as tdata
from micronet_tpu_torch.train import loop as tloop
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TRAJ_RTOL = 1e-3  # the loss of 3 whole steps, free running


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _dataset(n_train=64, n_test=32):
    tx, ty, ex, ey = tdata._synthetic(n_train, n_test)
    return tdata.Cifar10(tx, ty, ex, ey, source="synthetic")


def _trainer(model, ds=None, **cfg):
    return tloop.Trainer(model, tloop.TrainConfig(batch_size=8, log_every=0, **cfg),
                         dataset=ds or _dataset(), device="cpu")


@pytest.mark.parametrize("method,kw", [(None, {}), ("iao", dict(bn_fuse=True))])
def test_three_step_loss_trajectory(method, kw):
    """Whole steps, free running: the same batches (augmented once) through
    JAX's eager value_and_grad + optax.adamw and ``Trainer.train_step``."""
    jm = JLeNet(rngs=nnx.Rngs(0))
    tm = LeNet(device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    if method:
        jm = jprepare(jm, JQuantConfig(**kw), method=method)
        tm = prepare(tm, QuantConfig(**kw), method=method, device="cpu")
    jtrain(jm)
    tr = _trainer(tm, lr=1e-3, weight_decay=1e-7)
    train_mode(tm)
    jopt = nnx.Optimizer(jm, optax.adamw(1e-3, weight_decay=1e-7), wrt=nnx.Param)
    ds = _dataset()
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for k in range(3):
        xb = torch.from_numpy(ds.train_images[8 * k:8 * k + 8])
        x = tdata.augment_batch(gen, xb).numpy()
        y = ds.train_labels[8 * k:8 * k + 8]

        def loss_fn(m):
            return optax.softmax_cross_entropy_with_integer_labels(
                m(jnp.asarray(x)), jnp.asarray(y)).mean()

        loss, grads = nnx.value_and_grad(loss_fn)(jm)
        jopt.update(jm, grads)
        jl.append(float(loss))
        tl.append(float(tr.train_step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))[0]))
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
    assert tl[-1] != tl[0]
