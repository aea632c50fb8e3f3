"""micronet's NIN-GC (``models/nin_gc.py``): grouped convs with channel
shuffles, 32 x 32 x 3 images, 10 classes."""

from __future__ import annotations

from typing import List, Sequence

from ..arch import conv_bn

WIDTHS = (256, 256, 256, 512, 512, 512, 1024, 1024)


def ops(widths: Sequence[int] = WIDTHS, num_classes: int = 10) -> List[dict]:
    c = list(widths)

    def cbr(i, cin, cout, k, pad=0, groups=1, shuffle=0):
        p = f"model.layers.{i}"
        return conv_bn(f"{p}.conv", f"{p}.bn", cin, cout, k, 1, pad, groups, True, True,
                       shuffle)

    return [
        cbr(0, 3, c[0], 5, pad=2),
        cbr(1, c[0], c[1], 1, groups=2),
        cbr(2, c[1], c[2], 1, groups=2, shuffle=2),
        dict(kind="maxpool", k=2, stride=2),
        cbr(4, c[2], c[3], 3, pad=1, groups=16, shuffle=2),
        cbr(5, c[3], c[4], 1, groups=4, shuffle=16),
        cbr(6, c[4], c[5], 1, groups=4, shuffle=4),
        dict(kind="maxpool", k=2, stride=2),
        cbr(8, c[5], c[6], 3, pad=1, groups=32, shuffle=4),
        cbr(9, c[6], c[7], 1, groups=8, shuffle=32),
        cbr(10, c[7], num_classes, 1),
        dict(kind="avgpool", k=8, stride=1),
    ]
