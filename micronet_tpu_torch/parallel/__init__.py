"""Parallelism: the counterpart of ``micronet_tpu/parallel/``, over
``torch.distributed`` with one process a card (NCCL on the card, gloo on
the CPU): data and tensor (channel) parallelism (``initialize``,
``make_mesh``, ``shard_batch``, ``channel_sharding_for``, ``shard_state``,
``shard_model_and_optimizer``, the explicit-collective
``dp_shard_map_step``), Mixture-of-Experts on one device and
expert-parallel (``moe_apply_ep``, ``moe_apply_ep_a2a``), GPipe pipeline
parallelism (``pipeline_apply``, ``pipeline_apply_stateful``,
``stack_stage_params``) and ring-attention sequence parallelism
(``ring_attention``, ``attention_reference``). The collectives that XLA
inserts or ``shard_map`` names in the JAX package are written in
``distributed``; the expert, stage and seq axes are 1-D meshes of
``sharding.axis_mesh``.
"""

from .distributed import dp_shard_map_step, initialize
from .moe import (MoEParams, init_moe, load_balance_loss, moe_apply, moe_apply_ep,
                  moe_apply_ep_a2a, quantize_moe)
from .pipeline import pipeline_apply, pipeline_apply_stateful, stack_stage_params
from .sequence import attention_reference, ring_attention
from .sharding import (channel_sharding_for, make_mesh, shard_batch, shard_model_and_optimizer,
                       shard_state)

__all__ = ["MoEParams", "init_moe", "quantize_moe", "moe_apply", "moe_apply_ep",
           "moe_apply_ep_a2a", "load_balance_loss", "pipeline_apply",
           "pipeline_apply_stateful", "stack_stage_params", "ring_attention",
           "attention_reference", "initialize", "dp_shard_map_step", "make_mesh",
           "channel_sharding_for", "shard_state", "shard_model_and_optimizer", "shard_batch"]
