"""Checkpoints of the port against the JAX package's: a file written by
either package loads into the other's model (its state equal, the same
forward within 1e-6), the header round trip, the port's optimizer state
on resume, and JAX's loader keeping its own optimizer leaves, on NIN
(``cfg=[16] * 8``, IAO with BN folding) and LeNet."""

import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import nnx

from micronet_tpu.models import LeNet as JLeNet
from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu.train import checkpoint as jckpt
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.models.lenet import LeNet
from micronet_tpu_torch.nn import eval_mode, prepare
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import checkpoint as tckpt
from micronet_tpu_torch.train import data as tdata
from micronet_tpu_torch.train import loop as tloop
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CKPT_ATOL = 1e-6  # the same forward from a checkpoint read across packages


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


def _trainer(model):
    tx, ty, ex, ey = tdata._synthetic(64, 32)
    return tloop.Trainer(model, tloop.TrainConfig(batch_size=8, log_every=0, weight_decay=1e-7),
                         dataset=tdata.Cifar10(tx, ty, ex, ey, source="synthetic"),
                         device="cpu")


def _quant_nin_pair():
    """JAX and port NIN, IAO with BN folding, after two calibration
    forwards in JAX (non-trivial quantizer and BN state)."""
    jm = jprepare(jnin.Net(cfg=[16] * 8, rngs=nnx.Rngs(0)), JQuantConfig(bn_fuse=True),
                  method="iao")
    jtrain(jm)
    for i in range(2):
        jm(jnp.asarray(_np(30 + i, (2, 32, 32, 3))))
    tm = prepare(tnin.Net(cfg=[16] * 8, device="cpu"), QuantConfig(bn_fuse=True),
                 method="iao", device="cpu")
    return jm, tm


def test_checkpoints_read_both_ways(tmp_path):
    jm, tm = _quant_nin_pair()
    x = _np(40, (2, 32, 32, 3))
    jeval(jm)
    jout = np.asarray(jm(jnp.asarray(x)))
    jckpt.save_state(str(tmp_path / "j.npz"), jm, step=3, best_acc=0.5, extra={"cfg": [16] * 8})
    step, best, extra = tckpt.load_state(str(tmp_path / "j.npz"), tm)
    assert (step, best, extra) == (3, 0.5, {"cfg": [16] * 8})
    # the port read JAX's state exactly: the same model as through the interop
    ref = prepare(tnin.Net(cfg=[16] * 8, device="cpu"), QuantConfig(bn_fuse=True),
                  method="iao", device="cpu")
    ref.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    eval_mode(tm), eval_mode(ref)
    with torch.no_grad():
        tout = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(tout, ref(torch.from_numpy(x)).numpy(), rtol=0, atol=CKPT_ATOL)
    # and back: JAX reads the port's file into a fresh model, the same state
    tckpt.save_state(str(tmp_path / "t.npz"), tm, step=4, best_acc=0.25)
    jm2, _ = _quant_nin_pair()
    assert jckpt.load_state(str(tmp_path / "t.npz"), jm2) == (4, 0.25, {})
    f1, f2 = _flat(jm), _flat(jm2)
    assert set(f1) == set(f2) and all(np.array_equal(f1[k], f2[k]) for k in f1)
    jeval(jm2)
    np.testing.assert_allclose(np.asarray(jm2(jnp.asarray(x))), jout, rtol=0, atol=CKPT_ATOL)
    with np.load(str(tmp_path / "t.npz")) as z:
        assert set(z.files) - {"__header__"} == {f"model/{k}" for k in
                                                 jckpt.state_to_arrays(jm)}


def test_optimizer_state_round_trip_and_jax_keeps_its_own(tmp_path):
    tr = _trainer(LeNet(device="cpu"))
    ds = tr.data
    x = tdata.augment_batch(tr.gen, torch.from_numpy(ds.train_images[:8]))
    tr.train_step(x, torch.from_numpy(ds.train_labels[:8].astype(np.int64)))
    path = str(tmp_path / "r.npz")
    tckpt.save_state(path, tr.model, optimizer=tr.optimizer, step=0, best_acc=0.1)
    tr2 = _trainer(LeNet(device="cpu"))
    tckpt.load_state(path, tr2.model, optimizer=tr2.optimizer)
    for p, q in zip(tr.params, tr2.params):
        assert torch.equal(p, q)
        for k in ("mu", "nu", "count"):
            assert torch.equal(tr.optimizer.state[p][k], tr2.optimizer.state[q][k])
    # JAX's loader reads the model part and keeps its own optimizer leaves
    jm = JLeNet(rngs=nnx.Rngs(1))
    jopt = nnx.Optimizer(jm, optax.adam(1e-3), wrt=nnx.Param)
    assert jckpt.load_state(path, jm, optimizer=jopt)[0] == 0
