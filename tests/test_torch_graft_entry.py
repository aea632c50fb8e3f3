"""``micronet_tpu_torch.graft_entry.entry`` against the JAX package's
``__graft_entry__.entry``: the NIN-GC IAO W8A8 ``bn_fuse`` eval forward at
full width. The port's entry on the CPU (where ``"auto"`` keeps the exact
path), its observers and BN statistics calibrated by two training
forwards so that the forward is not a constant; that state carried into
JAX's entry state (the inverse of ``cnn_state_from_numpy``'s transposes);
then both eval forwards on 2 seeded images and on the example input. JAX
runs its entry's forward eagerly, as the function it returns."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from micronet_tpu_torch.graft_entry import EXAMPLE_BATCH, entry
from micronet_tpu_torch.interop import OIHW_TO_HWIO
from micronet_tpu_torch.nn import eval_mode, train_mode
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
# the same codes on both sides, f32 sums in another order through 9
# quantized layers; a value at a .5 edge may move a code, so the logits
# (of size ~1 to 10) are held to 1e-4 x max(1, max|logit|)
LOGIT_RTOL = 1e-4


def _jax_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def test_entry_forward_matches_jax_entry():
    fn, (x,) = entry("cpu")
    assert x.shape == (EXAMPLE_BATCH, 32, 32, 3) and x.dtype == torch.float32
    assert not fn.training and not bool(x.any())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        train_mode(fn)
        for _ in range(2):
            fn(torch.randn((4, 32, 32, 3), generator=gen) * 2)
        eval_mode(fn)
    port = fn.state_dict()
    forward, (state, jx) = _jax_entry()
    assert jx.shape == tuple(x.shape)
    flat = {}
    for path, var in state.flat_state():
        a = port.pop(".".join(str(p) for p in path)).numpy()
        flat[path] = var.replace(jnp.asarray(a.transpose(OIHW_TO_HWIO) if a.ndim == 4 else a))
    assert not port, f"port state without a JAX counterpart: {sorted(port)}"
    state = nnx.State.from_flat_path(flat)
    xs = torch.randn((2, 32, 32, 3), generator=gen) * 2
    for xi in (xs, x[:2]):
        with torch.no_grad():
            got = fn(xi).numpy()
        want = np.asarray(forward(state, jnp.asarray(xi.numpy())))
        assert got.shape == want.shape == (2, 10)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_RTOL * max(1.0, np.abs(want).max()))
    assert np.abs(got).max() > 0 and np.ptp(fn(xs).detach().numpy()) > 0
