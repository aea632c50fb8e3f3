"""Pipeline parallelism of the port (``parallel/pipeline.py``) in two gloo
processes on the CPU (``tests/_torch_serving_workers.py``), against the
JAX package's ``pipeline_apply`` and ``pipeline_apply_stateful`` on
``Mesh(jax.devices()[:2], ("stage",))``.

- ``pipeline_apply`` over ``tests/test_pipeline_parallel.py``'s MLP stage
  (dim 16, 4 microbatches of 4): outputs, every stage's gradients and the
  input's, 1e-5 absolute (the JAX test's).
- ``pipeline_apply_stateful`` over the dry run's stages (IAO W8A8
  ``bn_fuse`` ``ConvBNReLU(8, 8, 3)`` in training mode on 8 x 8 maps,
  2 x S microbatches of 2), JAX's weights moved in through
  ``cnn_state_from_numpy``, against JAX's fold: outputs 1e-5, gradients
  1e-4 x their largest magnitude, observers and BN statistics 1e-5 (f32
  convolutions summed in another order by XLA and by torch, as
  ``tests/test_torch_train_step.py`` holds a step block by block; the
  sums feed the observers' ranges); against JAX's pipeline, the loss
  within 1e-3 (the test's docstring says why).
- The pipeline against the port's own sequential fold, and one process
  alone (S = 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh

from _torch_serving_workers import _iao_stage, _mlp_stage, pipeline_worker, spawn
from micronet_tpu.models.nin import ConvBNReLU as JConvBNReLU
from micronet_tpu.nn import prepare as jprepare
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu.parallel import pipeline as jpipe
from micronet_tpu.quant.config import QuantConfig as JQuantConfig
from micronet_tpu_torch.graft_entry import _stage_fn
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.parallel import pipeline_apply, pipeline_apply_stateful
from micronet_tpu_torch.parallel import stack_stage_params
from micronet_tpu_torch.parallel.sharding import axis_mesh
from test_torch_sequence import world_of_one  # noqa: F401  (a fixture)

S, N_MICRO, MICRO, DIM = 2, 4, 4, 16
C, PP_MICRO = 8, 2
ATOL, GRAD_RTOL = 1e-5, 1e-4


def _mesh():
    return Mesh(np.array(jax.devices()[:S]), ("stage",))


def _jax_stages():
    out = []
    for i in range(S):
        blk = jprepare(JConvBNReLU(C, C, kernel_size=3, stride=1, padding=1, rngs=nnx.Rngs(i)),
                       JQuantConfig(a_bits=8, w_bits=8, bn_fuse=True), method="iao",
                       inplace=True)
        jtrain(blk)
        out.append(blk)
    return out


def _flat(state):
    return {path: np.asarray(v[...]) for path, v in state.flat_state()}


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(1)
    z = dict(w=(rng.randn(S, DIM, DIM) * 0.3).astype(np.float32),
             b=(rng.randn(S, DIM) * 0.1).astype(np.float32),
             x=rng.randn(N_MICRO, MICRO, DIM).astype(np.float32),
             tgt=rng.randn(N_MICRO, MICRO, DIM).astype(np.float32), c=np.int64(C))
    stages = _jax_stages()
    for s, blk in enumerate(stages):
        for path, v in _flat(nnx.state(blk)).items():
            z[f"stage{s}/" + "/".join(map(str, path))] = v
    px = np.random.default_rng(3).standard_normal((2 * S, PP_MICRO, 8, 8, C)).astype(np.float32)
    z["px"] = px.transpose(0, 1, 4, 2, 3).copy()  # the port's stages are NCHW
    np.savez(d / "in.npz", **z)
    spawn(pipeline_worker, S, d)
    with np.load(d / "out.npz") as o:
        return z, stages, px, {k: o[k] for k in o.files}


def test_pipeline_apply_equals_jax(pipe_run):
    z, _, _, port = pipe_run
    tgt = jnp.asarray(z["tgt"])

    def stage(p, h):
        return jax.nn.relu(h @ p["w"] + p["b"])

    def loss(p, x):
        y = jpipe.pipeline_apply(stage, p, x, _mesh())
        return jnp.mean((y - tgt) ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        {"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])}, jnp.asarray(z["x"]))
    for name, ref in (("mlp_y", y), ("mlp_gw", gp["w"]), ("mlp_gb", gp["b"]),
                      ("mlp_gx", gx)):
        np.testing.assert_allclose(port[name], np.asarray(ref), rtol=0, atol=ATOL,
                                   err_msg=name)


def _split(stages):
    gdef, _, _ = nnx.split(stages[0], nnx.Param, ...)
    plist, rlist = [], []
    for blk in stages:
        _, p, r = nnx.split(blk, nnx.Param, ...)
        plist.append(p)
        rlist.append(r)

    def stage_fn(params, rest, h):
        m = nnx.merge(gdef, params, rest)
        out = m(h)
        _, _, r2 = nnx.split(m, nnx.Param, ...)
        return out, r2

    return stage_fn, jpipe.stack_stage_params(plist), jpipe.stack_stage_params(rlist)


def _jax_pipeline_loss(stages, px):
    stage_fn, sp, sr = _split(stages)
    out, _ = jpipe.pipeline_apply_stateful(stage_fn, sp, sr, jnp.asarray(px), _mesh())
    return float(jnp.mean(out ** 2))


def _jax_fold(stages, px):
    """JAX's sequential fold, eager (``jax.grad`` without ``jit``)."""
    stage_fn, sp, sr = _split(stages)

    def loss(p):
        rests = [jax.tree.map(lambda a: a[s], sr) for s in range(S)]
        outs = []
        for mb in range(px.shape[0]):
            h = jnp.asarray(px[mb])
            for s in range(S):
                h, rests[s] = stage_fn(jax.tree.map(lambda a: a[s], p), rests[s], h)
            outs.append(h)
        out = jnp.stack(outs)
        return jnp.mean(out ** 2), (out, jpipe.stack_stage_params(rests))

    (_, (out, st)), g = jax.value_and_grad(loss, has_aux=True)(sp)
    return np.asarray(out), _flat(g), _flat(st)


def _per_stage(flat_stacked, s):
    return cnn_state_from_numpy({k: v[s] for k, v in flat_stacked.items()})


def test_pipeline_apply_stateful_equals_jax(pipe_run):
    """Outputs, every stage's parameter gradients, observer and BN state
    against JAX's sequential fold run eagerly, which JAX's pipeline
    equals (its docstring): JAX compiles ``shard_map`` even when called
    eagerly, and its compiled quantizers move an activation code here and
    there against its own eager stage,
    so JAX's pipeline is held to the port's by the loss only, within the
    dry run's 1e-3 (``__graft_entry__.py:228``, pipeline against fold)."""
    _, stages, px, port = pipe_run
    out, grads, state = _jax_fold(stages, px)
    np.testing.assert_allclose(port["pp_y"], out.transpose(0, 1, 4, 2, 3), rtol=0, atol=ATOL)
    gkeys = [k[len("pp_grad/"):] for k in port if k.startswith("pp_grad/")]
    skeys = [k[len("pp_state/"):] for k in port if k.startswith("pp_state/")]
    for s in range(S):
        jg, js = _per_stage(grads, s), _per_stage(state, s)
        assert sorted(jg) == sorted(gkeys) and sorted(js) == sorted(skeys)
        for k in gkeys:
            ref = jg[k].numpy()
            np.testing.assert_allclose(port[f"pp_grad/{k}"][s], ref, rtol=0,
                                       atol=GRAD_RTOL * max(1.0, np.abs(ref).max()),
                                       err_msg=f"stage {s} grad {k}")
        for k in skeys:
            np.testing.assert_allclose(port[f"pp_state/{k}"][s], js[k].numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"stage {s} state {k}")
    loss = float(np.mean(port["pp_y"].astype(np.float64) ** 2))
    np.testing.assert_allclose(loss, _jax_pipeline_loss(_jax_stages(), px), rtol=1e-3)


def _port_stages(z):
    flats = [{tuple(k.split("/")[1:]): v for k, v in z.items() if k.startswith(f"stage{s}/")}
             for s in range(S)]
    return [_iao_stage(f, C) for f in flats]


def test_stateful_pipeline_equals_the_port_fold(pipe_run):
    """The fold ``for mb: for stage: h, st = stage_fn(p, st, h)`` in one
    process on the same weights: outputs, and the state, which saw only
    real microbatches (no bubble zeros)."""
    z, _, _, port = pipe_run
    stages = _port_stages(z)
    fn = _stage_fn(stages[0])
    plist = [{k: v.detach() for k, v in m.named_parameters()} for m in stages]
    rests = [{k: v.detach().clone() for k, v in m.named_buffers()} for m in stages]
    outs = []
    with torch.no_grad():
        for mb in torch.from_numpy(z["px"]):
            h = mb
            for s in range(S):
                h, rests[s] = fn(plist[s], rests[s], h)
            outs.append(h)
    np.testing.assert_allclose(port["pp_y"], torch.stack(outs).numpy(), rtol=0, atol=ATOL)
    for s in range(S):
        for k, v in rests[s].items():
            np.testing.assert_allclose(port[f"pp_state/{k}"][s], v.numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"stage {s} {k}")


def test_single_stage_pipeline_is_the_stage(pipe_run, world_of_one):  # noqa: F811
    """S = 1: n_micro ticks, no exchange, no bubble; each microbatch
    through the stage in order, gradients and state included."""
    z, _, _, _ = pipe_run
    mesh = axis_mesh("stage", device="cpu")
    p = {n: torch.from_numpy(z[n][:1]).requires_grad_() for n in ("w", "b")}
    x = torch.from_numpy(z["x"])
    y = pipeline_apply(_mlp_stage, p, x, mesh)
    y.square().mean().backward()
    q = {n: torch.from_numpy(z[n][0]).requires_grad_() for n in ("w", "b")}
    yr = _mlp_stage(q, x)
    yr.square().mean().backward()
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(p["w"].grad[0], q["w"].grad, rtol=0, atol=1e-7)
    stage = _port_stages(z)[0]
    fn = _stage_fn(stage)
    params = stack_stage_params([{k: v.detach() for k, v in stage.named_parameters()}])
    state = stack_stage_params([{k: v.detach() for k, v in stage.named_buffers()}])
    px = torch.from_numpy(z["px"])
    out, new = pipeline_apply_stateful(fn, params, state, px, mesh)
    rest = {k: v[0].clone() for k, v in state.items()}
    with torch.no_grad():
        ref = []
        for mb in px:
            h, rest = fn({k: v[0] for k, v in params.items()}, rest, mb)
            ref.append(h)
    torch.testing.assert_close(out.detach(), torch.stack(ref), rtol=0, atol=0)
    for k, v in rest.items():
        torch.testing.assert_close(new[k][0], v, rtol=0, atol=0)
