"""One training step of every method, the port against ``jax.grad`` of
the JAX package, block by block (``tests/_torch_step_flow.py``): the
loss within 1e-5 relative, each block's output, input gradient and
parameter gradients within 1e-5 x max|g|, its observer and BN state after
the step within 1e-5, on LeNet (float, IAO, IAO with BN folding, DoReFa)
and NIN (``cfg=[16] * 8``; wbwtab W = 3 and W = 2) at batch 4."""

import pytest

from _torch_step_flow import run_case
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", ["float", "iao", "iao_bn_fuse"])
def test_one_step_matches_jax_grad(case):
    n, excused = run_case(case)
    assert n >= 12


def test_quant_add_union_gradients_match_jax():
    """``QuantAdd`` in training: both addends fake-quantize with the union
    of the two observers' ranges; the gradients to both addends (the
    clip-STE, half on a bound, the extreme elements sitting on it) equal
    ``jax.grad``'s, the output and the observers' state bit for bit."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax import nnx

    from micronet_tpu.nn import qat_iao as jqat
    from micronet_tpu.quant.config import QuantConfig as JQuantConfig
    from micronet_tpu_torch.nn import qat_iao as tqat
    from micronet_tpu_torch.quant.config import QuantConfig

    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 5, 4)).astype(np.float32) * 2
    b = rng.standard_normal((2, 5, 5, 4)).astype(np.float32) * 0.5
    r = rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
    jl = jqat.QuantAdd(cfg=JQuantConfig(a_bits=8, w_bits=8))
    tl = tqat.QuantAdd(cfg=QuantConfig(a_bits=8, w_bits=8), device="cpu")
    jout = np.asarray(nnx.clone(jl)(jnp.asarray(a), jnp.asarray(b)))
    ga, gb = nnx.grad(lambda m, x, y: jnp.sum(m(x, y) * r), argnums=(1, 2))(
        jl, jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(v.copy()).requires_grad_() for v in (a, b))
    tout = tl(ta, tb)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(), jout)
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(gb))
    k = int(np.abs(a).argmax())  # the union's bound: half the gradient
    assert float(ta.grad.reshape(-1)[k]) == 0.5 * float(r.reshape(-1)[k])
    jstate = {".".join(map(str, k)): np.asarray(v[...]) for k, v in nnx.state(jl).flat_state()}
    for name, t in tl.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), jstate[name])
