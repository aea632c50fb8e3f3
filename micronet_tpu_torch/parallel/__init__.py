"""Parallelism: the counterpart of ``micronet_tpu/parallel/``.

Ported so far: the single-device half of ``parallel/moe.py`` (top-1 and
top-k Mixture-of-Experts with static capacity, int8 experts, the
load-balancing loss). Left out, not ported yet: ``initialize``,
``dp_shard_map_step``, ``make_mesh``, ``channel_sharding_for``,
``shard_state``, ``shard_model_and_optimizer`` and ``shard_batch`` (data
and tensor parallelism; ROADMAP.md, Queue 1 item 1), ``moe_apply_ep``,
``moe_apply_ep_a2a``, ``pipeline_apply``, ``pipeline_apply_stateful``,
``stack_stage_params``, ``ring_attention`` and ``attention_reference``
(expert, pipeline and sequence parallelism; Queue 1 item 2).
"""

from .moe import MoEParams, init_moe, load_balance_loss, moe_apply, quantize_moe

__all__ = ["MoEParams", "init_moe", "quantize_moe", "moe_apply", "load_balance_loss"]
