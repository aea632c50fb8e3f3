"""Inference export: BN fusion and the integer engine."""

from .bn_fuse import fuse_bn_iao, pre_quantize_weights
from .engine import freeze_int

__all__ = ["fuse_bn_iao", "pre_quantize_weights", "freeze_int"]
