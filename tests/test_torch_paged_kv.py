"""The port's paged KV pool against the JAX package's, field by field.

The same scripted sequence of appends, batched appends (with inactive
lanes), pool exhaustion, slot-capacity saturation, a partial insert,
frees and re-allocation runs through ``micronet_tpu.quant.paged_kv`` and
``micronet_tpu_torch.quant.paged_kv`` on the same numpy inputs; after
every operation every field (codes, scales, page table, lengths, free
stack, free top) must be equal, bit for bit: both quantize with the same
rule and both allocators are deterministic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micronet_tpu.quant import kv_cache as jkv
from micronet_tpu.quant import paged_kv as jpk
from micronet_tpu_torch.quant import kv_cache as tkv
from micronet_tpu_torch.quant import paged_kv as tpk

_FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale", "page_table", "lengths",
           "free_stack", "free_top")


class _Pair:
    """A JAX pool and a port pool driven by the same calls."""

    def __init__(self, *args, **kw):
        self.j = jpk.init_paged_kv(*args, **kw)
        self.t = tpk.init_paged_kv(*args, **kw, device="cpu")
        self.check("init")

    def check(self, what):
        for f in _FIELDS:
            a = getattr(self.t, f).numpy()
            b = np.asarray(getattr(self.j, f))
            assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")

    def append(self, slot, k, v):
        self.j = jpk.paged_append(self.j, slot, jnp.asarray(k), jnp.asarray(v))
        tpk.paged_append(self.t, slot, torch.from_numpy(k), torch.from_numpy(v))
        self.check(f"append to slot {slot}")

    def append_batch(self, kv, active):
        kq, ks = jkv.quantize_kv_rows(jnp.asarray(kv))
        self.j = jpk.paged_append_batch(self.j, kq, ks[..., 0], kq, ks[..., 0],
                                        jnp.asarray(active))
        tq, ts = tkv.quantize_kv_rows(torch.from_numpy(kv))
        tpk.paged_append_batch(self.t, tq, ts[..., 0], tq, ts[..., 0],
                               torch.from_numpy(np.asarray(active)))
        self.check(f"append_batch active={active}")

    def free(self, slot):
        self.j = jpk.paged_free_slot(self.j, slot)
        tpk.paged_free_slot(self.t, slot)
        self.check(f"free slot {slot}")

    def insert(self, slot, dense, length):
        self.j = jpk.paged_insert_from_dense(self.j, slot, *map(jnp.asarray, dense),
                                             jnp.int32(length))
        tpk.paged_insert_from_dense(self.t, slot, *map(torch.from_numpy, dense), length)
        self.check(f"insert {length} rows into slot {slot}")


def _kv(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _dense(rng, h, s, d):
    """A slot's prefilled dense rows, quantized as the dense cache does."""
    c = tkv.append_kv(tkv.init_kv_cache(h, s, d, device="cpu"),
                      torch.from_numpy(_kv(rng, h, s, d)), torch.from_numpy(_kv(rng, h, s, d)))
    return (c.k_codes.numpy(), c.k_scale[..., 0].numpy(), c.v_codes.numpy(),
            c.v_scale[..., 0].numpy())


def test_scripted_allocator_sequence_matches_jax_field_by_field():
    """8 pages (7 usable) of 4 rows, 3 slots of up to 3 pages."""
    rng = np.random.default_rng(0)
    h, d, ps, mp, slots = 2, 8, 4, 3, 3
    pool = _Pair(8, ps, h, d, slots, mp)
    for _ in range(5):  # slot 0 across a page boundary
        pool.append(0, _kv(rng, h, d), _kv(rng, h, d))
    for _ in range(4):  # slot 1 fills exactly one page
        pool.append(1, _kv(rng, h, d), _kv(rng, h, d))
    for _ in range(6):  # slot 1 inactive: it never pops
        pool.append_batch(_kv(rng, slots, h, d), [True, False, True])
    # every lane active until the pool runs dry and slot 0 saturates at
    # its 12-row capacity: skipped appends write nothing and pop nothing
    for _ in range(6):
        pool.append_batch(_kv(rng, slots, h, d), [True, True, True])
    assert int(pool.t.free_top) == 0 and int(pool.t.lengths[0]) == mp * ps
    pool.free(1)
    # the slot wants 3 pages, the stack holds fewer: a partial insert
    assert int(pool.t.free_top) < 3
    pool.insert(1, _dense(rng, h, mp * ps, d), 11)
    assert int(pool.t.lengths[1]) < 11
    pool.free(0)
    pool.free(0)  # idempotent on an empty slot
    for _ in range(5):  # re-allocation from the recycled pages
        pool.append(0, _kv(rng, h, d), _kv(rng, h, d))
    pool.free(2)
    pool.insert(2, _dense(rng, h, mp * ps, d), 7)


@pytest.mark.parametrize("pages,appends", [(8, 4 + 3), (2, 4)])
def test_single_slot_saturation_matches_jax(pages, appends):
    """Slot capacity (2 pages of 2 rows, then 3 appends past it) and pool
    exhaustion (1 usable page): the append is skipped, the zero page stays
    zero, and freeing never pushes page 0."""
    rng = np.random.default_rng(pages)
    pool = _Pair(pages, 2, 1, 8, 1, 2)
    for _ in range(appends):
        pool.append(0, _kv(rng, 1, 8), _kv(rng, 1, 8))
    assert int(pool.t.lengths[0]) == (4 if pages == 8 else 2)
    assert not pool.t.k_codes[0].any() and not pool.t.k_scale[0].any()
    pool.free(0)
    assert 0 not in pool.t.free_stack[: int(pool.t.free_top)].tolist()


def test_gather_dense_and_hbm_bytes_match_jax():
    rng = np.random.default_rng(3)
    h, d = 2, 16
    pool = _Pair(8, 4, h, d, 2, 4)
    for _ in range(11):  # 3 pages, the last one partly filled
        pool.append(0, _kv(rng, h, d), _kv(rng, h, d))
    for slot in (0, 1):
        got = tpk.paged_gather_dense(pool.t, slot)
        want = jpk.paged_gather_dense(pool.j, slot)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tpk.paged_hbm_bytes(pool.t) == jpk.paged_hbm_bytes(pool.j) == 2 * 8 * h * 4 * (d + 4)


def test_pool_rows_equal_the_dense_cache_rows():
    """Appending the same tokens to a pool and to a dense cache gives the
    same codes and scales in the gathered view."""
    rng = np.random.default_rng(4)
    h, d, n = 2, 16, 11
    k, v = _kv(rng, h, n, d), _kv(rng, h, n, d)
    flat = tkv.append_kv(tkv.init_kv_cache(h, 16, d, device="cpu"),
                         torch.from_numpy(k), torch.from_numpy(v))
    pool = tpk.init_paged_kv(8, 4, h, d, 2, 4, device="cpu")
    for t in range(n):
        tpk.paged_append(pool, 0, torch.from_numpy(k[:, t]), torch.from_numpy(v[:, t]))
    kc, ks, vc, vs, length = tpk.paged_gather_dense(pool, 0)
    assert int(length) == n
    assert torch.equal(kc[:, :n], flat.k_codes[:, :n])
    assert torch.equal(ks[:, :n], flat.k_scale[:, :n, 0])
    assert torch.equal(vc[:, :n], flat.v_codes[:, :n])
    assert torch.equal(vs[:, :n], flat.v_scale[:, :n, 0])

