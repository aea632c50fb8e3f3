"""BN-gamma network-slimming channel pruning."""

from .slimming import (bn_l1_grad_update, compute_prune_masks, gc_base_numbers, prune_model,
                       sparsity_report)

__all__ = ["bn_l1_grad_update", "compute_prune_masks", "gc_base_numbers", "prune_model",
           "sparsity_report"]
