"""bf16 inference (``infer/bf16.py``) against the JAX package's on the CPU:
the JAX test's NIN (``cfg=[8] * 8``, BN statistics from two train-mode
forwards), its weights carried to the port through
``cnn_state_from_numpy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_engine_flow import _flat, _x
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from micronet_tpu.infer import bf16_runner as jbf16_runner
from micronet_tpu.infer import to_bf16 as jto_bf16
from micronet_tpu.models import nin as jnin
from micronet_tpu.nn import eval_mode as jeval
from micronet_tpu.nn import train_mode as jtrain
from micronet_tpu_torch.infer import bf16_runner, to_bf16
from micronet_tpu_torch.interop import cnn_state_from_numpy
from micronet_tpu_torch.models import nin
from micronet_tpu_torch.nn import eval_mode


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    jm = jnin.Net(cfg=[8] * 8, rngs=nnx.Rngs(0))
    jtrain(jm)
    for i in range(2):
        jm(jnp.asarray(_x(i, (4, 32, 32, 3))))
    jeval(jm)
    tm = nin.Net(cfg=[8] * 8, device="cpu")
    tm.load_state_dict(cnn_state_from_numpy(_flat(jm), tm))
    eval_mode(tm)
    x = _x(9, (4, 32, 32, 3))
    with torch.no_grad():
        y_f32 = tm(torch.from_numpy(x)).numpy()
    jy_f32 = np.asarray(jm(jnp.asarray(x)))
    f32_bytes = sum(t.numel() * t.element_size() for t in tm.state_dict().values())
    to_bf16(tm)
    with torch.no_grad():
        y_bf = bf16_runner(tm)(torch.from_numpy(x))
    jy_bf = np.asarray(jax.jit(jbf16_runner(jto_bf16(jm)))(jnp.asarray(x)))
    return dict(tm=tm, y_f32=y_f32, jy_f32=jy_f32, f32_bytes=f32_bytes, y_bf=y_bf, jy_bf=jy_bf)


def test_bf16_state_takes_under_0_6_of_f32(models):
    bf_bytes = sum(t.numel() * t.element_size() for t in models["tm"].state_dict().values())
    assert bf_bytes < 0.6 * models["f32_bytes"]
    assert all(t.dtype == torch.bfloat16 for t in models["tm"].state_dict().values()
               if t.is_floating_point())


def test_runner_returns_f32_within_bf16_tolerance(models):
    """The JAX test's bound: within 0.05 relative L2 of the f32 output."""
    assert models["y_bf"].dtype == torch.float32
    assert _rel(models["y_bf"].numpy(), models["y_f32"]) < 0.05


def test_bf16_matches_jax_bf16(models):
    """The f32 models agree to 1e-4 (sums in another order); in bf16 each
    layer rounds its output to 8 significant bits, and the two packages
    round at other places (XLA keeps some elementwise chains in f32 before
    the one rounding), so an activation may land one bf16 ulp (2^-8
    relative) apart and the difference grows through 9 layers. Each side
    is within the 0.05 of f32 the JAX test allows, so the two lie within
    0.05 of each other, and their gap is no larger than either's gap to
    f32."""
    np.testing.assert_allclose(models["y_f32"], models["jy_f32"], rtol=0, atol=1e-4)
    y_bf = models["y_bf"].numpy()
    gap = _rel(y_bf, models["jy_bf"])
    assert gap < 0.05
    assert gap <= max(_rel(y_bf, models["y_f32"]), _rel(models["jy_bf"], models["jy_f32"]))
