"""Device ms per training step of every kernel that is no convolution:
fake-quant chains, observers, BN, the loss, Adam, casts, cuDNN's layout
transposes. A kernel is a convolution (forward, data or weight gradient)
when its name says so and it is none of cuDNN's layout kernels."""

import re

from portbench import readings

_CONV = re.compile(r"conv|gemm|wgrad|dgrad|fprop|xmma", re.IGNORECASE)
_LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw|SliceC|transpose", re.IGNORECASE)


def is_conv(name: str) -> bool:
    return bool(_CONV.search(name)) and not _LAYOUT.search(name)


def read(run):
    st = readings.stretch_of(run, "train", multi=False)
    if st is None:
        return None
    return readings.per_step(st, readings.kernel_seconds(st, lambda n: not is_conv(n))) * 1e3
