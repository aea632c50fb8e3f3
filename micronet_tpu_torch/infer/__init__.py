"""Inference export: BN fusion and the integer engines."""

from .bn_fuse import fuse_bn_iao, fuse_bn_wbwtab, pre_quantize_weights
from .engine import freeze_int, freeze_wbwtab

__all__ = ["fuse_bn_iao", "fuse_bn_wbwtab", "pre_quantize_weights", "freeze_int",
           "freeze_wbwtab"]
