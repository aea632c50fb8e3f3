"""The CIFAR ResNet-18 of micronet's ``models/resnet.py``: a 3 x 3 stem,
four stages of two basic blocks at widths 64 to 512, 10 classes (the
residual design of He et al., arXiv:1512.03385)."""

from __future__ import annotations

from typing import List, Sequence

from ..arch import conv_bn

WIDTHS = (64, 128, 256, 512)


def ops(widths: Sequence[int] = WIDTHS, num_classes: int = 10) -> List[dict]:
    out = [conv_bn("conv1.layers.0", "conv1.layers.1", 3, widths[0], 3, pad=1, bias=False)]
    cin = widths[0]
    for stage, (cout, first_stride) in enumerate(zip(widths, (1, 2, 2, 2))):
        for b, stride in enumerate((first_stride, 1)):
            p = f"conv{stage + 2}_x.layers.{b}"
            r = f"{p}.residual_function.layers"
            shortcut = None
            if stride != 1 or cin != cout:
                shortcut = conv_bn(f"{p}.shortcut.layers.0", f"{p}.shortcut.layers.1", cin,
                                   cout, 1, stride, 0, bias=False, relu=False)
            out.append(dict(kind="block", key=p, residual=[
                conv_bn(f"{r}.0", f"{r}.1", cin, cout, 3, stride, 1, bias=False),
                conv_bn(f"{r}.3", f"{r}.4", cout, cout, 3, 1, 1, bias=False, relu=False),
            ], shortcut=shortcut))
            cin = cout
    return out + [dict(kind="gap"), dict(kind="fc", key="fc", cin=cin, cout=num_classes)]
