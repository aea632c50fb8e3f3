"""Parallelism: the counterpart of ``micronet_tpu/parallel/``.

Ported so far: the single-device half of ``parallel/moe.py`` (top-1 and
top-k Mixture-of-Experts with static capacity, int8 experts, the
load-balancing loss). Not ported yet (ROADMAP.md, Queue 1 item 6:
parallelism): the expert-parallel ``moe_apply_ep`` and
``moe_apply_ep_a2a``, ring attention and sequence-parallel prefill,
data, tensor and pipeline parallelism.
"""

from .moe import MoEParams, init_moe, load_balance_loss, moe_apply, quantize_moe

__all__ = ["MoEParams", "init_moe", "quantize_moe", "moe_apply", "load_balance_loss"]
