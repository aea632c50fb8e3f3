"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch twins.

The JAX package's ops surface, with each XLA oracle ``*_xla`` under its
twin's name ``*_ref``: ``int8_matmul_dequant_ref`` in place of
``int8_matmul_dequant_xla``. Beside it, the module ``requant_epilogue``
holds the integer engine's one-pass conv epilogue, which has no TPU kernel
(XLA fuses it there), and the module ``dwconv`` its 3 x 3 depthwise conv
(the JAX package runs it as a block-diagonal GEMM), and the module
``patch_gather`` its patch matrices and int8 channel shuffles (XLA's
convolutions and gathers there). Importing this package registers the
operators (``torch.ops.micronet_tpu_torch``)."""

from . import dwconv, patch_gather, requant_epilogue  # noqa: F401  (register their operators)
from .int_matmul import (binary_act_matmul, int8_linear, int8_matmul_dequant,
                         int8_matmul_dequant_ref, quantize_int8)

__all__ = ["binary_act_matmul", "int8_linear", "int8_matmul_dequant", "int8_matmul_dequant_ref",
           "quantize_int8"]
