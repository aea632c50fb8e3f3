"""Inference export: BN fusion, the integer engines, the paired
equivalence evaluation and parameter dumps."""

from .bn_fuse import fuse_bn_iao, fuse_bn_wbwtab, pre_quantize_weights
from .engine import freeze_int, freeze_wbwtab
from .evaluate import evaluate_model, paired_equivalence_eval

__all__ = ["fuse_bn_iao", "fuse_bn_wbwtab", "pre_quantize_weights", "freeze_int",
           "freeze_wbwtab", "evaluate_model", "paired_equivalence_eval"]
