"""Functional NN ops: the counterpart of ``micronet_tpu/nn/functional.py``.

The JAX package runs NHWC activations and HWIO kernels; the port runs
NCHW activations and OIHW kernels inside its models (their public
``forward`` takes NHWC, as the JAX models do). Semantics are torch's:
symmetric integer padding, ``count_include_pad=True`` average pooling.
Transposed convolutions take torch's weight layout (in, out // groups,
kh, kw); the JAX package's is (kh, kw, in, out // groups). The channel
shuffle records the span ``fn.shuffle`` (``utils/profiling.py``; off by
default): the models call it directly, outside any module's span.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as TF

from ..ops.patch_gather import patch_shuffle, patch_shuffle_ref
from ..utils.profiling import span

__all__ = [
    "sqrt",
    "conv2d",
    "conv_transpose2d",
    "linear",
    "leaky_relu",
    "max_pool2d",
    "avg_pool2d",
    "adaptive_avg_pool2d",
    "channel_shuffle",
]

IntPair = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's. torch's vectorized
    CPU ``sqrt`` may miss by an ulp; taken in f64 and rounded once to f32
    it is exact (f64 holds more than twice f32's precision)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
           groups: int = 1) -> torch.Tensor:
    """NCHW x OIHW -> NCHW; ``weight`` is (out, in // groups, kh, kw). The
    bias is added after the convolution, as the JAX package does."""
    y = TF.conv2d(x, weight, None, _pair(stride), _pair(padding), _pair(dilation), groups)
    return y if bias is None else y + bias[:, None, None]


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: IntPair = 1,
                     padding: IntPair = 0, output_padding: IntPair = 0, dilation: IntPair = 1,
                     groups: int = 1) -> torch.Tensor:
    """Transposed convolution, NCHW x (in, out // groups, kh, kw) -> NCHW,
    torch semantics: the gradient of ``conv2d`` with respect to its input.
    The JAX package computes it as a convolution of the input dilated by
    ``stride`` with the flipped kernel and edge padding ``d * (k - 1) - p``
    (``+ output_padding`` on the high side), a crop where that is
    negative; the values are the same. The bias is added after."""
    y = TF.conv_transpose2d(x, weight, None, _pair(stride), _pair(padding),
                            _pair(output_padding), groups, _pair(dilation))
    return y if bias is None else y + bias[:, None, None]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight (+ bias)`` with weight (in, out)."""
    y = x.to(torch.float32) @ weight.to(torch.float32)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``negative_slope * x`` (``jax.nn``'s
    form)."""
    return torch.where(x >= 0, x, negative_slope * x)


def max_pool2d(x: torch.Tensor, kernel_size: IntPair, stride: Optional[IntPair] = None,
               padding: IntPair = 0) -> torch.Tensor:
    """Max pooling over NCHW; padding never wins. Integer codes pool
    through f32 (exact for int8) and come back in their own dtype."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    if x.dtype.is_floating_point:
        return TF.max_pool2d(x, k, s, _pair(padding))
    return TF.max_pool2d(x.to(torch.float32), k, s, _pair(padding)).to(x.dtype)


def avg_pool2d(x: torch.Tensor, kernel_size: IntPair, stride: Optional[IntPair] = None,
               padding: IntPair = 0, count_include_pad: bool = True) -> torch.Tensor:
    """Average pooling over NCHW (divides by the full window by default)."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    y = TF.avg_pool2d(x.to(torch.float32), k, s, _pair(padding),
                      count_include_pad=count_include_pad)
    return y.to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: IntPair) -> torch.Tensor:
    """Adaptive average pooling to (H, W): bin i spans
    [floor(i*In/Out), ceil((i+1)*In/Out))."""
    oh, ow = _pair(output_size)
    if (oh, ow) == (1, 1):
        return torch.mean(x, dim=(2, 3), keepdim=True)
    h, w = x.shape[2], x.shape[3]
    if h % oh == 0 and w % ow == 0:
        return avg_pool2d(x, (h // oh, w // ow), stride=(h // oh, w // ow))
    return TF.adaptive_avg_pool2d(x, (oh, ow))


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel shuffle for grouped convolutions over NCHW: output channel
    ``k * groups + r`` is input channel ``r * (C / groups) + k``, where the
    JAX package gathers by a permutation for the TPU's layouts. The integer
    engine's int8 codes on the card take one pass of the hand-written
    kernel (``ops/patch_gather.py::patch_shuffle``), which reads their NHWC
    memory and returns an NCHW view of NHWC memory, as the next conv reads
    it; every other tensor (the float shuffles of training, any CPU
    tensor) a reshape and a transpose, one copy on the device, the
    kernel's twin. Neither moves an index tensor from the host, so the
    shuffle runs inside a CUDA graph capture."""
    n, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    with span("fn.shuffle"):
        if x.dtype == torch.int8 and x.dim() == 4 and x.device.type == "cuda":
            return patch_shuffle(x, groups)
        return patch_shuffle_ref(x, groups)
