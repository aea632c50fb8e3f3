"""DoReFa-Net quantizers (arXiv 1606.06160): the counterpart of
``micronet_tpu/quant/dorefa.py``. Stateless and closed-form: the scales
are fixed by the bit width, so there is no observer or buffer.

Every function does the JAX package's f32 operations in its order; only
the round is straight-through (``ste_round``), so gradients flow through
the clip, ``tanh`` and the max-normalization as autograd gives them. The
clip is ``rounding.clip``, which halves the gradient on a bound as
``jnp.clip`` does; divisions by the grid step are ``rounding.true_div``,
so the card rounds them as the CPU and XLA do.
"""

from __future__ import annotations

import torch

from .rounding import clip, ste_round, true_div

__all__ = ["quantize_activation", "activation_codes", "quantize_weight"]


def _check_bits(bits: int, what: str) -> None:
    if bits == 1:
        raise ValueError(f"binary {what} are not supported by the DoReFa path; use "
                         "micronet_tpu_torch.quant.wbwtab")


def activation_codes(x: torch.Tensor, a_bits: int):
    """(codes, scale) with ``quantize_activation(x) == codes * scale``:
    codes are integers in ``[0, 2^a - 1]``, carrying the STE round and the
    clip's gradient mask."""
    _check_bits(a_bits, "activations")
    x = clip(x.to(torch.float32) * 0.1, 0.0, 1.0)
    scale = 1.0 / float((1 << a_bits) - 1)
    return ste_round(true_div(x, scale)), scale


def quantize_activation(x: torch.Tensor, a_bits: int) -> torch.Tensor:
    """``clip(x * 0.1, 0, 1)`` (the x0.1 pre-scale cuts clipping error),
    then the uniform grid of step ``1 / (2^a - 1)`` with an STE round.
    ``a_bits == 32`` passes ``x`` through; 1 bit raises (use wbwtab)."""
    if a_bits == 32:
        return x
    codes, scale = activation_codes(x, a_bits)
    return (codes * scale).to(x.dtype)


def quantize_weight(w: torch.Tensor, w_bits: int) -> torch.Tensor:
    """``tanh(w) / (2 max|tanh(w)|) + 0.5`` onto the grid of step
    ``1 / (2^w - 1)``, then back to [-1, 1] as ``2q - 1``. ``w_bits == 32``
    passes ``w`` through; 1 bit raises (use wbwtab)."""
    if w_bits == 32:
        return w
    _check_bits(w_bits, "weights")
    t = torch.tanh(w.to(torch.float32))
    t = t / (2.0 * torch.max(torch.abs(t))) + 0.5
    scale = 1.0 / float((1 << w_bits) - 1)
    q = ste_round(true_div(t, scale)) * scale
    return (2.0 * q - 1.0).to(w.dtype)
