"""Parallelism: the counterpart of ``micronet_tpu/parallel/``.

Ported: data and tensor (channel) parallelism over ``torch.distributed``,
one process per card (``initialize``, ``make_mesh``, ``shard_batch``,
``channel_sharding_for``, ``shard_state``, ``shard_model_and_optimizer``,
the explicit-collective ``dp_shard_map_step``; the reductions XLA inserts
under GSPMD are written in ``distributed``), and the single-device half of
``parallel/moe.py`` (top-1 and top-k Mixture-of-Experts with static
capacity, int8 experts, the load-balancing loss). Left out, not ported
yet: ``moe_apply_ep``, ``moe_apply_ep_a2a``, ``pipeline_apply``,
``pipeline_apply_stateful``, ``stack_stage_params``, ``ring_attention``
and ``attention_reference`` (expert, pipeline and sequence parallelism;
ROADMAP.md, Queue 1 item 2).
"""

from .distributed import dp_shard_map_step, initialize
from .moe import MoEParams, init_moe, load_balance_loss, moe_apply, quantize_moe
from .sharding import (channel_sharding_for, make_mesh, shard_batch, shard_model_and_optimizer,
                       shard_state)

__all__ = ["MoEParams", "init_moe", "quantize_moe", "moe_apply", "load_balance_loss",
           "initialize", "dp_shard_map_step", "make_mesh", "channel_sharding_for",
           "shard_state", "shard_model_and_optimizer", "shard_batch"]
