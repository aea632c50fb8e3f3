"""The port's package surface against the JAX package's: every name in a
JAX ``__all__`` is exported by the port's counterpart (``*_xla`` oracles
under their twins' names ``*_ref``) or named in its docstring as left
out; every exported name resolves; ``quantize_int8_weight(_grouped)``
equals JAX's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

PACKAGES = ["", ".infer", ".models", ".nn", ".ops", ".quant", ".serve", ".utils", ".parallel",
            ".train", ".prune"]


@pytest.mark.parametrize("sub", PACKAGES)
def test_every_jax_name_is_exported_or_listed_as_left_out(sub):
    jmod = importlib.import_module("micronet_tpu" + sub)
    tmod = importlib.import_module("micronet_tpu_torch" + sub)
    missing = [name for name in jmod.__all__
               if name.replace("_xla", "_ref") not in tmod.__all__
               and f"``{name}``" not in (tmod.__doc__ or "")]
    assert not missing, f"micronet_tpu_torch{sub} neither exports nor lists {missing}"


@pytest.mark.parametrize("sub", PACKAGES)
def test_every_exported_name_resolves(sub):
    tmod = importlib.import_module("micronet_tpu_torch" + sub)
    assert len(set(tmod.__all__)) == len(tmod.__all__)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_weight_equals_jax(axis):
    from micronet_tpu.quant import weight_only as jwo
    from micronet_tpu_torch.quant import weight_only as two

    w = np.random.default_rng(axis).standard_normal((96, 40)).astype(np.float32) * 0.05
    jq, js = jwo.quantize_int8_weight(jnp.asarray(w), axis=axis)
    tq, ts = two.quantize_int8_weight(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("group", [8, 32])
def test_quantize_int8_weight_grouped_equals_jax(group):
    from micronet_tpu.quant import weight_only as jwo
    from micronet_tpu_torch.quant import weight_only as two

    w = np.random.default_rng(group).standard_normal((96, 40)).astype(np.float32) * 0.05
    jq, js = jwo.quantize_int8_weight_grouped(jnp.asarray(w), group)
    tq, ts = two.quantize_int8_weight_grouped(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
