"""The training pipeline of the port against the JAX package: the
synthetic set (byte for byte), the augmentation's applying half (fed the
offsets and flips JAX draws, bit for bit), Adam and AdamW against optax on
the same gradients (within 1e-6 relative), ``grad_accum`` against the
full batch, a ResNet QAT step, and ``Trainer.fit`` end to end, on LeNet
and NIN (``cfg=[16] * 8``) at batch 4 to 8 (checkpoints:
``test_torch_checkpoint.py``; a 3-step loss trajectory against JAX:
``test_torch_trajectory.py``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu.train import data as jdata
from micronet_tpu.train import loop as jloop
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.models.lenet import LeNet
from micronet_tpu_torch.nn import prepare, train_mode
from micronet_tpu_torch.nn import modules as M
from micronet_tpu_torch.quant.config import QuantConfig
from micronet_tpu_torch.train import data as tdata
from micronet_tpu_torch.train import loop as tloop
from micronet_tpu_torch.train.optim import Adam
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

OPT_RTOL = 1e-6  # parameter updates, relative to max|update|


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _dataset(n_train=64, n_test=32):
    tx, ty, ex, ey = tdata._synthetic(n_train, n_test)
    return tdata.Cifar10(tx, ty, ex, ey, source="synthetic")


# -------------------------------------------------------------------- data


def test_synthetic_set_byte_equal(monkeypatch):
    for noise in ("0.6", "1.7"):
        monkeypatch.setenv("MICRONET_SYNTHETIC_NOISE", noise)
        for a, b in zip(tdata._synthetic(300, 256), jdata._synthetic(300, 256)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    monkeypatch.delenv("MICRONET_SYNTHETIC_NOISE")
    monkeypatch.setenv("MICRONET_SYNTHETIC_SIZE", "260")
    t, j = tdata.load_cifar10(), jdata.load_cifar10()
    assert t.source == j.source == "synthetic" and t.train_images.shape == (260, 32, 32, 3)
    for name in ("train_images", "train_labels", "test_images", "test_labels"):
        assert getattr(t, name).tobytes() == getattr(j, name).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentation_applies_jax_draws_bit_for_bit(seed):
    images = np.random.default_rng(seed).integers(0, 256, (9, 32, 32, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jdata.augment_batch(key, jnp.asarray(images)))
    k1, k2 = jax.random.split(key)
    offs = np.asarray(jax.random.randint(k1, (9, 2), 0, 9))
    flips = np.asarray(jax.random.bernoulli(k2, 0.5, (9, 1, 1, 1))).reshape(-1)
    got = tdata.apply_augment(torch.from_numpy(images), torch.from_numpy(offs),
                              torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdata.normalize_batch(torch.from_numpy(images)).numpy(),
                                  np.asarray(jdata.normalize_batch(jnp.asarray(images))))


def test_augmentation_draws():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    offs, flips = tdata.draw_augment(g1, 4096)
    assert offs.shape == (4096, 2) and int(offs.min()) == 0 and int(offs.max()) == 8
    assert 0.45 < float(flips.float().mean()) < 0.55
    o2, f2 = tdata.draw_augment(g2, 4096)
    assert torch.equal(offs, o2) and torch.equal(flips, f2)


def test_epoch_batches_shuffle_and_cover():
    ds = _dataset(70, 30)
    gen = torch.Generator().manual_seed(3)
    seed = tdata.perm_seed(torch.Generator().manual_seed(3))
    idx = np.arange(70)
    np.random.RandomState(seed).shuffle(idx)
    got = list(tdata.epoch_batches(gen, ds.train_images, ds.train_labels, 16))
    assert len(got) == 4
    for i, (xb, yb) in enumerate(got):
        np.testing.assert_array_equal(xb, ds.train_images[idx[16 * i:16 * i + 16]])
        np.testing.assert_array_equal(yb, ds.train_labels[idx[16 * i:16 * i + 16]])
    tail = list(tdata.epoch_batches(None, ds.test_images, ds.test_labels, 16, shuffle=False,
                                    drop_remainder=False))
    assert [len(y) for _, y in tail] == [16, 14]


def test_lr_schedule_equals_jax():
    for epochs in (1, 2, 5, 20, 300, 400):
        assert tloop.scaled_milestones(epochs) == jloop.scaled_milestones(epochs)
    for e in (0, 79, 80, 130, 299):
        assert tloop.lr_at_epoch(1e-3, e) == jloop.lr_at_epoch(1e-3, e)


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("wd", [0.0, 1e-7, 5e-2])
def test_adam_and_adamw_updates_equal_optax(wd):
    """Three updates on the same gradients, the learning rate changed
    between them as the trainer does each epoch. Updates of about 1
    (learning rates of 1 and 0.5) on parameters that stay under 3, from
    the same parameters each step, are read from ``after - before`` to
    an ulp of the parameter (under 1e-6 of the update)."""
    shapes = [(5, 5, 3, 6), (6,), (120, 84)]
    params = [_np(i, s, 1e-3) for i, s in enumerate(shapes)]
    grads = [[_np(10 * k + i, s, 0.1) for i, s in enumerate(shapes)] for k in range(3)]
    lrs = (1.0, 1.0, 0.5)
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.adamw(learning_rate, weight_decay=wd) if wd
        else optax.adam(learning_rate))(learning_rate=lrs[0])
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Adam(tp, lr=lrs[0], weight_decay=wd)
    for k in range(3):
        state.hyperparams["learning_rate"] = jnp.asarray(lrs[k])
        upd, state = tx.update([jnp.asarray(g) for g in grads[k]], state, jp)
        before = [p.copy() for p in map(np.asarray, jp)]
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = lrs[k]
        for p, b, g in zip(tp, before, grads[k]):
            p.data.copy_(torch.from_numpy(b))  # the same start: one rounding of p + u apart
            p.grad = torch.from_numpy(g)
        opt.step()
        for b, j, t in zip(before, jp, tp):
            dj, dt = np.asarray(j) - b, t.detach().numpy() - b
            np.testing.assert_allclose(dt, dj, rtol=0, atol=OPT_RTOL * np.abs(dj).max())


def _trainer(model, ds=None, **cfg):
    return tloop.Trainer(model, tloop.TrainConfig(batch_size=8, log_every=0, **cfg),
                         dataset=ds or _dataset(), device="cpu")


@pytest.mark.parametrize("method", [None, "iao"])
def test_parameters_are_the_jax_params(method):
    """The optimizer takes exactly the JAX package's ``nnx.Param`` set;
    quantizer and BN statistics stay buffers."""
    jm = jnin.Net(cfg=[16] * 8, rngs=nnx.Rngs(0))
    tm = tnin.Net(cfg=[16] * 8, device="cpu")
    if method:
        jm = jprepare(jm, JQuantConfig(bn_fuse=True), method=method)
        tm = prepare(tm, QuantConfig(bn_fuse=True), method=method, device="cpu")
    want = {".".join(map(str, k)) for k, _ in nnx.state(jm, nnx.Param).flat_state()}
    tr = _trainer(tm)
    names = {id(p): n for n, p in tm.named_parameters()}
    got = {names[id(p)] for g in tr.optimizer.param_groups for p in g["params"]}
    assert got == want and len(tr.params) == len(want)


def test_grad_accum_equals_the_full_batch():
    """A net without batch statistics: two microbatches' averaged
    gradients equal the full batch's."""
    def net():
        g = torch.Generator().manual_seed(0)
        return M.Sequential(M.Conv2d(3, 4, 3, device="cpu", generator=g), M.ReLU(),
                            M.AvgPool2d(30), M.Flatten(), M.Linear(4, 10, device="cpu",
                                                                    generator=g))

    class Nhwc(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.body = net()

        def forward(self, x):
            return self.body(x.permute(0, 3, 1, 2))

    x = torch.from_numpy(_np(4, (8, 32, 32, 3)))
    y = torch.from_numpy(np.arange(8) % 10)
    full, acc = _trainer(Nhwc(), lr=0.0), _trainer(Nhwc(), lr=0.0, grad_accum=2)
    lf, _ = full.train_step(x, y)
    la, _ = acc.train_step(x, y)
    assert float(la) == pytest.approx(float(lf), rel=1e-6)
    # the same terms summed per microbatch, then added: f32 sums in another
    # order, within the 1e-5 x max|g| held across packages
    for pf, pa in zip(full.params, acc.params):
        torch.testing.assert_close(pa.grad, pf.grad, rtol=0, atol=1e-5 * pf.grad.abs().max())


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloop.Trainer(LeNet(device="cpu"), tloop.TrainConfig(), dataset=_dataset(), mesh=object(),
                      device="cpu")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_step_equals_plain_step(grad_accum):
    """Two IAO ``bn_fuse`` steps with ``remat=True`` against plain ones from
    the same weights: every parameter, gradient and buffer equal bit for
    bit (the first step seeds the BN statistics, the second runs the EMA).
    The recompute runs (the first block's forward is called twice a
    microbatch) from the buffers as they were before the forward: a
    recompute from the updated ones would see other scales."""
    cfg = QuantConfig(a_bits=8, w_bits=8, bn_fuse=True)
    plain = prepare(LeNet(device="cpu", generator=torch.Generator().manual_seed(0)), cfg,
                    device="cpu")
    remat = prepare(LeNet(device="cpu", generator=torch.Generator().manual_seed(0)), cfg,
                    device="cpu")
    tp = _trainer(train_mode(plain), grad_accum=grad_accum)
    tr = _trainer(train_mode(remat), grad_accum=grad_accum, remat=True)
    calls = []
    remat.features.layers[0].register_forward_hook(lambda *a: calls.append(1))
    for k in range(2):
        x = torch.from_numpy(_np(10 + k, (8, 32, 32, 3)))
        y = torch.from_numpy(np.arange(8) % 10)
        lp, _ = tp.train_step(x, y)
        lr, _ = tr.train_step(x, y)
        assert torch.equal(lr, lp)
        for (name, a), b in zip(remat.named_parameters(), plain.parameters()):
            assert torch.equal(a.grad, b.grad), name
            assert torch.equal(a, b), name
        for (name, a), b in zip(remat.named_buffers(), plain.buffers()):
            assert torch.equal(a, b), name
    assert len(calls) == 2 * 2 * grad_accum


def test_fit_end_to_end_with_checkpoints_and_metrics(tmp_path):
    ds = _dataset(48, 20)
    metrics = tmp_path / "m.jsonl"
    tr = tloop.Trainer(LeNet(device="cpu"),
                       tloop.TrainConfig(batch_size=16, epochs=2, log_every=1,
                                         metrics_path=str(metrics), async_checkpoint=True,
                                         keep_latest=True),
                       dataset=ds, device="cpu")
    logs = []
    best = tr.fit(checkpoint_path=str(tmp_path / "c.npz"), log=logs.append, restore_best=True)
    assert 0.0 <= best <= 1.0 and tr.epoch == 2
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["event"] for r in rows] == ["run_start", "epoch", "eval", "epoch", "eval"]
    assert len(rows[1]["step_ms"]) == 3 and len(rows[1]["step_loss"]) == 3
    assert (tmp_path / "c.npz.latest.npz").exists()
    assert any("batch 0" in line for line in logs)


def test_resnet_iao_step_through_quant_add():
    """A QAT step of a small ResNet with BN folding: each residual
    ``QuantAdd`` quantizes both addends with one scale in one forward, and
    the backward finds the scale its first use saved."""
    from micronet_tpu_torch.models.resnet import BasicBlock, ResNet

    model = prepare(ResNet(BasicBlock, [1, 1, 1, 1], device="cpu"), QuantConfig(bn_fuse=True),
                    device="cpu")
    tr = _trainer(train_mode(model))
    before = [p.detach().clone() for p in tr.params]
    x = tdata.augment_batch(tr.gen, torch.from_numpy(tr.data.train_images[:8]))
    loss, _ = tr.train_step(x, torch.from_numpy(tr.data.train_labels[:8].astype(np.int64)))
    assert np.isfinite(float(loss))
    assert all(not torch.equal(b, p) for b, p in zip(before, tr.params))
