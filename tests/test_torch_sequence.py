"""Ring attention of the port (``parallel/sequence.py``) in two and four
gloo processes on the CPU (``tests/_torch_serving_workers.py``, which
import only the port), against the JAX package's ``ring_attention`` on
``Mesh(jax.devices()[:S], ("seq",))`` of the conftest's CPU devices, at
the size of ``tests/test_sequence_parallel.py`` (T 32, H 2, D 8).

Tolerance: 1e-5 absolute on values and on the gradients of
``mean((y - tgt)^2)``, the JAX tests' own (f32 sums in another order:
the port's block products are torch einsums, JAX's XLA dots). One
process alone (S = 1) holds the port's ring to its dense oracle.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from _torch_serving_workers import RING_CASES, sequence_worker, spawn
from micronet_tpu.parallel import sequence as jseq
from micronet_tpu_torch.parallel import attention_reference, ring_attention
from micronet_tpu_torch.parallel.sequence import _zigzag_maps
from micronet_tpu_torch.parallel.sharding import axis_mesh

T, H, D = 32, 2, 8
ATOL = 1e-5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((T, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "tgt")}


def _jax_case(z, s, causal, balanced, t=T):
    mesh = Mesh(np.array(jax.devices()[:s]), ("seq",))
    q, k, v, tgt = (jnp.asarray(z[n][:t]) for n in ("q", "k", "v", "tgt"))

    def loss(q, k, v):
        y = jseq.ring_attention(q, k, v, mesh, causal=causal, balanced=balanced)
        return jnp.mean((y - tgt) ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [y, *g]


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def ring_run(request, tmp_path_factory):
    """The port's ring attention in S ranks (each schedule, values and
    gradients), and the inputs."""
    s = request.param
    d = tmp_path_factory.mktemp(f"ring{s}")
    z = _inputs(s)
    np.savez(d / "in.npz", **z)
    spawn(sequence_worker, s, d)
    with np.load(d / "out.npz") as o:
        return s, z, {k: o[k] for k in o.files}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_values_and_grads_equal_jax(ring_run, case):
    """Zigzag (S = 2: stripes 0 and 3 on rank 0; S = 4: the stripe maps'
    least trivial case), contiguous causal and full attention."""
    s, z, port = ring_run
    causal, balanced = RING_CASES[case]
    for i, (name, ref) in enumerate(zip(("y", "dq", "dk", "dv"),
                                        _jax_case(z, s, causal, balanced))):
        np.testing.assert_allclose(port[f"{case}_{i}"], np.asarray(ref), rtol=0, atol=ATOL,
                                   err_msg=f"{case} {name} S={s}")


def test_odd_local_length_takes_the_contiguous_schedule(ring_run):
    """T/S odd: the balanced schedule cannot split the block, so both
    packages fall back to the contiguous one."""
    s, z, port = ring_run
    for i, ref in enumerate(_jax_case(z, s, True, True, t=3 * s)):
        np.testing.assert_allclose(port[f"odd_{i}"], np.asarray(ref), rtol=0, atol=ATOL)


def test_zigzag_maps_are_jax_stripe_maps(ring_run):
    s, _, port = ring_run
    t_e = [2 * i if 2 * i < s else 2 * s - 1 - 2 * i for i in range(s)]
    t_o = [2 * i + 1 if 2 * i + 1 < s else 2 * s - 2 - 2 * i for i in range(s)]
    assert port["maps"].tolist() == [t_e, t_o] == [list(m) for m in _zigzag_maps(s)]


def test_attention_reference_equals_jax():
    z = _inputs(9)
    for causal in (True, False):
        ref = jseq.attention_reference(*(jnp.asarray(z[n]) for n in "qkv"), causal=causal)
        got = attention_reference(*(torch.from_numpy(z[n]) for n in "qkv"), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.fixture
def world_of_one():
    """A one-process gloo world, torn down after the test (later tests in
    this worker expect no process group)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_single_rank_ring_is_the_dense_oracle(world_of_one):
    """S = 1: one block, no exchange, the oracle's values and gradients
    (the ring accumulates in f32 with the running max; the oracle
    softmaxes whole rows)."""
    mesh = axis_mesh("seq", device="cpu")
    z = _inputs(11)
    for causal in (True, False):
        got = [torch.from_numpy(z[n]).requires_grad_() for n in "qkv"]
        ref = [torch.from_numpy(z[n]).requires_grad_() for n in "qkv"]
        yg = ring_attention(*got, mesh, causal=causal)
        yr = attention_reference(*ref, causal=causal)
        yg.square().mean().backward()
        yr.square().mean().backward()
        torch.testing.assert_close(yg, yr, rtol=0, atol=ATOL)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=ATOL)
