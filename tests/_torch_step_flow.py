"""One training step of the port against the JAX package, block by block
(shared by ``test_torch_train_step*.py``).

A quantized net is chaotic across the packages: where an f32 sum in
another order moves a value across a rounding edge (a code, a sign), the
change reaches every later observer and BN statistic. So each port block
is fed JAX's input to it (recorded by a forward through a clone of the
JAX model, in training mode) and JAX's gradient of the loss with respect
to its output, and must give JAX's output, JAX's gradient with respect
to its input and its parameters, and JAX's state after the step. JAX
runs eagerly: ``nnx.grad`` of one block at a time, never a jitted step.

Edges: a block whose own quantizers see a value within ``EDGE`` of a
rounding edge, with an input the two packages compute differently (a
BN-folded weight, a DoReFa ``tanh``, a sign of a BN output, a ternary
threshold), may round it the other way; such a block is left out and
counted, and at most a quarter of a model's blocks may be.
"""

import numpy as np
import optax
import torch
import torch.nn.functional as TF
from flax import nnx

import jax
import jax.numpy as jnp
from micronet_tpu.models import LeNet as JLeNet
from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin as tnin
from micronet_tpu_torch.models.lenet import LeNet
from micronet_tpu_torch.nn import prepare, qat_dorefa, qat_iao, qat_wbwtab, train_mode
from micronet_tpu_torch.quant.config import QuantConfig

EDGE = 1e-4  # grid units (codes)
SIGN_EDGE = 1e-5  # |x| of a value whose sign is taken (BN outputs of size ~1)
CENTER_EDGE = 1e-6  # |w - mean| of a binary weight (means of size ~0.1)
TERNARY_EDGE = 1e-5  # relative to the ternary threshold
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # x max|g| (input grads: of the block; parameter grads: of the step)
FWD_RTOL = 1e-5  # x max(1, max|out|)
STATE_RTOL = 1e-5  # observer and BN statistics, x max(1, |value|)


def to_port(a):
    a = np.asarray(a)
    return np.array(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a, order="C")


def from_port(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def blocks(model):
    """The model's blocks in order: NIN/NIN-GC's ``model.layers``, LeNet's
    features, flatten and classifier."""
    if hasattr(model, "features"):
        return list(model.features.layers) + [model.flatten] + list(model.classifier.layers)
    return list(model.model.layers)


def _near_half(v):
    v = np.asarray(v, np.float64)
    return np.abs(v - np.floor(v) - 0.5) < EDGE


def _edge_hooks(block, found):
    """Forward hooks that note quantizers of ``block`` seeing a value near
    a rounding edge, where their input differs between the packages."""
    handles = []
    for m in block.modules():
        if isinstance(m, qat_iao.QuantBNFuseConv2d):
            def hook(mod, inp, out):
                v = inp[0].detach().double() / mod.scale.double() - mod.zero_point.double()
                found.append(bool(_near_half(v.numpy()).any()))
            handles.append(m.weight_quantizer.register_forward_hook(hook))
        elif isinstance(m, (qat_dorefa.QuantConv2d, qat_dorefa.QuantLinear)):
            t = np.tanh(m.weight.detach().double().numpy())
            found.append(bool(_near_half((t / (2 * np.abs(t).max()) + 0.5)
                                         * ((1 << m.w_bits) - 1)).any()))
        elif isinstance(m, qat_wbwtab.ActivationQuantizer) and m.A == 2:
            def hook(mod, inp, out):
                found.append(bool((inp[0].detach().abs() < SIGN_EDGE).any()))
            handles.append(m.register_forward_hook(hook))
        elif isinstance(m, qat_wbwtab.QuantConv2d) and m.W in (2, 3):
            w = m.weight.detach().double()
            if m.W == 3:
                a = w.abs()
                thr = 0.7 * a.mean(dim=(1, 2, 3), keepdim=True)
                found.append(bool(((a - thr).abs() < TERNARY_EDGE * thr).any()))
            else:
                c = w - w.mean(dim=1, keepdim=True)
                found.append(bool((c.abs() < CENTER_EDGE).any()))
    return handles


def _close(got, want, rtol, scale=None, what=""):
    scale = max(1.0, np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


@nnx.jit
def _block_grad(block, x, g):
    """One block's VJP (its parameters and input) for the cotangent ``g``:
    a jitted block, not a jitted step."""
    return nnx.grad(lambda m, a: jnp.sum(m(a) * g), argnums=(0, 1))(block, x)


def blockwise_step(jmodel, tmodel, x, y):
    """Run the step block by block in both packages and compare; returns
    (number of blocks, number left out at an edge)."""
    n = x.shape[0]
    jfwd = nnx.clone(jmodel)
    xs = [jnp.asarray(x)]
    for b in blocks(jfwd):
        xs.append(b(xs[-1]))
    logits = xs[-1].reshape(n, -1)
    jloss, g = jax.value_and_grad(
        lambda lg: optax.softmax_cross_entropy_with_integer_labels(lg, jnp.asarray(y)).mean()
    )(logits)
    g = g.reshape(xs[-1].shape)
    jb, tb = blocks(jmodel), blocks(tmodel)
    assert len(jb) == len(tb)
    # JAX's backward, block by block: (cotangent in, parameter grads, input grad)
    jgrads = [None] * len(jb)
    for i in reversed(range(len(jb))):
        gi = g
        pg, g = _block_grad(jb[i], xs[i], gi)
        jgrads[i] = (gi, {".".join(map(str, k)): np.asarray(v[...])
                          for k, v in pg.flat_state()}, np.asarray(g))
    # gradients are held to 1e-5 x the largest of the step (a gradient that
    # is 0 in exact arithmetic, such as a conv bias before a BN, is f32 noise)
    gmax = max(np.abs(v).max() for _, pgj, _ in jgrads for v in pgj.values())
    excused, tloss = 0, None
    for i in range(len(jb)):
        gi, pgj, gj = jgrads[i]
        xt = torch.from_numpy(to_port(xs[i])).requires_grad_()
        found = []
        handles = _edge_hooks(tb[i], found)
        out = tb[i](xt)
        for h in handles:
            h.remove()
        (out * torch.from_numpy(to_port(gi))).sum().backward()
        if i == len(jb) - 1:  # the port's loss from JAX's input to the last block
            tloss = TF.cross_entropy(out.detach().reshape(n, -1), torch.from_numpy(y))
        if any(found):
            excused += 1
            continue
        what = f"block {i} ({type(tb[i]).__name__})"
        _close(from_port(out), np.asarray(xs[i + 1]), FWD_RTOL, what=what + " output")
        _close(from_port(xt.grad), gj, GRAD_RTOL, np.abs(gj).max(), what + " input grad")
        tps = dict(tb[i].named_parameters())
        assert set(tps) == set(pgj), what
        for name, p in tps.items():
            want = pgj[name]
            _close(p.grad.numpy(), want.transpose(3, 2, 0, 1) if want.ndim == 4 else want,
                   GRAD_RTOL, gmax, f"{what} grad of {name}")
        jstate = {".".join(map(str, k)): np.asarray(v[...])
                  for k, v in nnx.state(jb[i]).flat_state()}
        for name, t in tb[i].state_dict().items():
            want = jstate[name]
            want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
            _close(t.numpy().astype(np.float64), want.astype(np.float64), STATE_RTOL,
                   what=f"{what} state {name}")
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert excused <= len(jb) // 4, f"{excused} of {len(jb)} blocks at an edge"
    return len(jb), excused


def _flat(module):
    return {path: np.asarray(v[...]) for path, v in nnx.state(module).flat_state()}


CASES = {
    "float": ("lenet", None, {}),
    "iao": ("lenet", "iao", dict(a_bits=8, w_bits=8)),
    "iao_bn_fuse": ("lenet", "iao", dict(a_bits=4, w_bits=4, bn_fuse=True)),
    "dorefa": ("lenet", "dorefa", dict(a_bits=4, w_bits=4)),
    "wbwtab_w3": ("nin", "wbwtab", dict(W=3, A=2)),
    "wbwtab_w2": ("nin", "wbwtab", dict(W=2, A=2)),
}


def run_case(case):
    """Build both packages' model of ``case``, take one step block by
    block; returns (blocks, blocks left out at an edge)."""
    arch, method, kw = CASES[case]
    if arch == "lenet":
        jm, tm = JLeNet(rngs=nnx.Rngs(0)), LeNet(device="cpu")
    else:
        jm, tm = jnin.Net(cfg=[16] * 8, rngs=nnx.Rngs(0)), tnin.Net(cfg=[16] * 8, device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm)))
    if method is not None:
        jm = jprepare(jm, JQuantConfig(**kw), method=method)
        tm = prepare(tm, QuantConfig(**kw), method=method, device="cpu")
    jtrain(jm)
    train_mode(tm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4)
    return blockwise_step(jm, tm, x, y)
