"""Sequence parallelism: ring attention over a ``seq`` axis, the counterpart
of ``micronet_tpu/parallel/sequence.py``.

Each rank of the axis (a 1-D mesh of ``parallel.sharding.axis_mesh``, one
process a rank) takes a contiguous (T/S, H, D) block of q, k and v, and S
ticks rotate the K/V blocks around the ring (``distributed.ppermute``: a
batched ``isend``/``irecv`` pair a tick, the reverse pair in the
backward). At tick s a rank attends its queries against the block that
started s hops away, keeping the flash-attention accumulators (running
row max m, normalizer l, weighted sum acc) in f32, so the result is exact
softmax attention, not an approximation. Causal masks come from the
global positions.

:func:`ring_attention` takes and gives the global (T, H, D) arrays on
every rank, as the JAX package's caller sees them: each rank cuts out its
block (``distributed.split``) and the blocks of the result are gathered
(``distributed.gather``). Causal attention takes the zigzag (striped)
schedule of :func:`_ring_attention_zigzag` where the local length is
even, else the contiguous one. The block update is plain torch in the JAX
package's order of operations (the JAX package computes it in XLA, not
Pallas), not ``scaled_dot_product_attention``; it is differentiable end to
end.

Every rank takes part in every exchange, forward and backward, in the
same order: each exchange's results are used on every rank (a masked
block still enters the accumulators, as in JAX), and the ring skips only
the rotation after its last tick, on every rank alike.
"""

from __future__ import annotations

import torch

__all__ = ["ring_attention", "attention_reference"]

_NEG_BIG = -1e30


def _scale(d: int, device) -> torch.Tensor:
    """``1 / sqrt(D)`` in f32, as ``1.0 / jnp.sqrt(float(d))``."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=device))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Dense multi-head attention oracle: q, k, v (T, H, D) -> (T, H, D)."""
    scores = torch.einsum("thd,shd->hts", q, k) * _scale(q.shape[-1], q.device)
    if causal:
        t = q.shape[0]
        pos = torch.arange(t, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = torch.where(mask[None], scores, torch.tensor(float("-inf"), device=q.device))
    return torch.einsum("hts,shd->thd", torch.softmax(scores, dim=-1), v)


def _block(qf, k_blk, v_blk, m, l, acc, scale, mask=None):
    """One online-softmax update of (m, l, acc) by a block of keys; mask
    None means every key is visible."""
    scores = torch.einsum("thd,uhd->htu", qf, k_blk) * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_BIG)
    m_new = torch.maximum(m, torch.amax(scores, dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    if mask is not None:
        # a row with no visible key yet keeps p exactly 0
        p = torch.where(mask, p, 0.0)
    l_new = l * alpha + torch.sum(p, dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("htu,uhd->htd", p, v_blk)
    return m_new, l_new, acc_new


def _finish(acc, l, dtype):
    """(H, t, D) accumulators -> (t, H, D) attention."""
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).transpose(0, 1).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "seq",
                   causal: bool = True, balanced: bool = True) -> torch.Tensor:
    """Exact attention of q, k, v (T, H, D) with the sequence cut over
    ``mesh``'s ``axis``: :func:`attention_reference` on the same arrays up
    to the order of the sums, with O((T/S)^2) score blocks a rank.

    Causal mode takes the zigzag schedule (:func:`_ring_attention_zigzag`)
    unless ``balanced=False`` or the local length T/S is odd; then the
    contiguous one, whose last rank computes every block while the first
    computes one."""
    from .distributed import gather, ppermute, split
    from .sharding import axis_rank, axis_size

    s_ranks = axis_size(mesh, axis)
    t_total, n_heads, d = q.shape
    if t_total % s_ranks:
        raise ValueError(f"T={t_total} does not divide over {s_ranks} ranks")
    t_loc = t_total // s_ranks
    if causal and balanced and s_ranks > 1 and t_loc % 2 == 0:
        return _ring_attention_zigzag(q, k, v, mesh, axis)
    group, i = mesh.get_group(axis), axis_rank(mesh, axis)
    q, k, v = (split(a, 0, group) for a in (q, k, v))
    scale = _scale(d, q.device)
    ring = [(r + 1) % s_ranks for r in range(s_ranks)]  # each block to the next rank
    ar = torch.arange(t_loc, device=q.device)
    q_pos = i * t_loc + ar
    qf = q.to(torch.float32)
    k_blk, v_blk = k, v
    acc = torch.zeros((n_heads, t_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((n_heads, t_loc), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((n_heads, t_loc), dtype=torch.float32, device=q.device)
    for s in range(s_ranks):
        src = (i - s) % s_ranks  # the rank this block started on
        ok = None
        if causal:
            ok = (q_pos[None, :, None] >= (src * t_loc + ar)[None, None, :])
        m, l, acc = _block(qf, k_blk.to(torch.float32), v_blk.to(torch.float32), m, l, acc,
                           scale, ok)
        if s < s_ranks - 1:
            k_blk, v_blk = ppermute((k_blk, v_blk), ring, group)
    return gather(_finish(acc, l, q.dtype), 0, group)


def _zigzag_maps(s_ranks: int):
    """Stripe 2i (rank i's first half) goes to rank ``t_e[i]``, stripe
    2i + 1 to ``t_o[i]``; both maps are permutations of the ranks."""
    t_e = [2 * i if 2 * i < s_ranks else 2 * s_ranks - 1 - 2 * i for i in range(s_ranks)]
    t_o = [2 * i + 1 if 2 * i + 1 < s_ranks else 2 * s_ranks - 2 - 2 * i
           for i in range(s_ranks)]
    return t_e, t_o


def _ring_attention_zigzag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           axis: str = "seq") -> torch.Tensor:
    """Causal ring attention in the zigzag (striped) layout, the balanced
    schedule: T is cut into 2S stripes of h = T/(2S) and rank i holds
    stripes i and 2S-1-i. Tick 0 attends the two local triangles and the
    late stripe against the early one; every later tick exactly two full,
    unmasked block pairs: the late queries against the arriving early
    keys, and either the early queries against them (the source stripe is
    past) or the late queries against the arriving late keys (it is
    future). The same cost on every rank. Takes and gives the contiguous
    layout, as :func:`ring_attention`: one exchange moves the halves of q,
    k and v into the stripes on entry, one moves the result back."""
    from .distributed import gather, ppermute, split
    from .sharding import axis_rank, axis_size

    s_ranks = axis_size(mesh, axis)
    group, i = mesh.get_group(axis), axis_rank(mesh, axis)
    t_total, n_heads, d = q.shape
    if t_total % (2 * s_ranks):
        raise ValueError(f"T={t_total} does not divide into {2 * s_ranks} stripes")
    h = t_total // s_ranks // 2
    scale = _scale(d, q.device)
    dtype = q.dtype
    t_e, t_o = _zigzag_maps(s_ranks)
    inv_e = [t_e.index(r) for r in range(s_ranks)]
    inv_o = [t_o.index(r) for r in range(s_ranks)]
    ring = [(r + 1) % s_ranks for r in range(s_ranks)]
    even = i % 2 == 0

    blocks = [split(a, 0, group).to(torch.float32) for a in (q, k, v)]
    # one exchange: each first half to t_e, each second half to t_o
    recv = ppermute([b[:h] for b in blocks] + [b[h:] for b in blocks],
                    [t_e] * 3 + [t_o] * 3, group)
    rec_e, rec_o = recv[:3], recv[3:]
    lo = rec_e if even else rec_o  # stripe i
    hi = rec_o if even else rec_e  # stripe 2S-1-i
    (q_lo, k_lo, v_lo), (q_hi, k_hi, v_hi) = lo, hi

    zeros_acc = torch.zeros((n_heads, h, d), dtype=torch.float32, device=q.device)
    zeros_l = torch.zeros((n_heads, h), dtype=torch.float32, device=q.device)
    m0 = torch.full((n_heads, h), _NEG_BIG, dtype=torch.float32, device=q.device)
    # tick 0, the diagonal: both local triangles, then the late stripe
    # against the early one (always visible)
    tri = torch.tril(torch.ones((h, h), dtype=torch.bool, device=q.device))[None]
    m_a, l_a, acc_a = _block(q_lo, k_lo, v_lo, m0, zeros_l, zeros_acc, scale, tri)
    m_b, l_b, acc_b = _block(q_hi, k_hi, v_hi, m0, zeros_l, zeros_acc, scale, tri)
    m_b, l_b, acc_b = _block(q_hi, k_lo, v_lo, m_b, l_b, acc_b, scale)
    k_lo_b, k_hi_b, v_lo_b, v_hi_b = k_lo, k_hi, v_lo, v_hi
    for s in range(1, s_ranks):
        # rotate first: the resident pair then started s hops away
        k_lo_b, k_hi_b, v_lo_b, v_hi_b = ppermute((k_lo_b, k_hi_b, v_lo_b, v_hi_b), ring,
                                                  group)
        src = (i - s) % s_ranks  # the stripe pair (src, 2S-1-src)
        m_b, l_b, acc_b = _block(q_hi, k_lo_b, v_lo_b, m_b, l_b, acc_b, scale)
        if src < i:  # their early stripe is our early one's past
            m_a, l_a, acc_a = _block(q_lo, k_lo_b, v_lo_b, m_a, l_a, acc_a, scale)
        else:  # their late stripe is our late one's past
            m_b, l_b, acc_b = _block(q_hi, k_hi_b, v_hi_b, m_b, l_b, acc_b, scale)
    out_lo, out_hi = _finish(acc_a, l_a, dtype), _finish(acc_b, l_b, dtype)
    # back through the inverse maps: each rank's contiguous halves
    half0, half1 = ppermute((out_lo if even else out_hi, out_hi if even else out_lo),
                            [inv_e, inv_o], group)
    return gather(torch.cat([half0, half1], dim=0), 0, group)
