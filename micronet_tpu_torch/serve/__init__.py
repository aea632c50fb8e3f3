"""Continuous-batching serving loop and token sampling.

Left out: ``position_key``, the JAX package's per-position
``jax.random`` key; its counterpart here is ``position_generator``, a
``torch.Generator`` per (seed, position)."""

from .sampling import generate_sampled, position_generator, sample_token, sample_token_batch
from .scheduler import Request, ServeLoop

__all__ = ["Request", "ServeLoop", "sample_token", "sample_token_batch", "position_generator",
           "generate_sampled"]
