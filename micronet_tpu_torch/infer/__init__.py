"""Inference export: BN fusion (both schemes), weight pre-quantization,
the integer engines, the paired equivalence evaluation, parameter dumps,
and the deploy end: batch-bucket engines on CUDA graphs, ``torch.export``
artifacts and bf16 inference."""

from .bf16 import bf16_runner, to_bf16
from .bn_fuse import fuse_bn_iao, fuse_bn_wbwtab, pre_quantize_weights
from .deploy import CompiledEngine, build_engine, deserialize_engine, serialize_engine
from .engine import (IntAdd, IntConcat, IntConv2d, IntConvTranspose2d, IntLinear, TernaryConv2d,
                     freeze_int, freeze_wbwtab)
from .evaluate import evaluate_model, paired_equivalence_eval

__all__ = ["fuse_bn_iao", "fuse_bn_wbwtab", "pre_quantize_weights", "freeze_int",
           "freeze_wbwtab", "TernaryConv2d", "IntConv2d", "IntConvTranspose2d", "IntLinear",
           "IntAdd", "IntConcat", "evaluate_model", "paired_equivalence_eval", "CompiledEngine",
           "build_engine", "serialize_engine", "deserialize_engine", "to_bf16", "bf16_runner"]
