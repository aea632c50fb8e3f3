"""MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2) at 32 x 32 x 3
and 10 classes: a 3 x 3 stem, 17 inverted residuals (a 1 x 1 expansion
with ReLU6 where t > 1, a 3 x 3 depthwise conv with ReLU6, a linear 1 x 1
projection; an identity add with no ReLU where the stride is 1 and the
width stays), a 1 x 1 head to 1,280, the global average pool and a linear
classifier. The stem and the c = 24 stage run at stride 1 (published: 2),
so 32 x 32 ends at 4 x 4; the classifier's Dropout, the identity at
inference, is left out. Keys follow torchvision's ``mobilenet_v2`` as the
port's module tree holds them (``features.layers.<i>``).

Op records beyond :mod:`..arch`'s: a ``conv_bn`` with ``relu6`` clamps at 6
after its ReLU; a ``block`` with ``relu`` False adds with no ReLU after.
:class:`Net` runs them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..arch import conv_bn
from ..iao import IaoNet

# the stem's width, each stage's c, the head's width
WIDTHS = (32, 16, 24, 32, 64, 96, 160, 320, 1280)
# (expansion t, repeats n) of each stage
SETTINGS = ((1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1))
# the stem's stride, then each stage's first block's (published: 2, 1, 2, 2, 2, 1, 2, 1)
STRIDES = (1, 1, 1, 2, 2, 1, 2, 1)


def _cbr6(conv: str, bn: str, cin: int, cout: int, k: int, stride: int = 1,
          groups: int = 1) -> dict:
    return dict(conv_bn(conv, bn, cin, cout, k, stride, (k - 1) // 2, groups, bias=False),
                relu6=True)


def ops(widths: Sequence[int] = WIDTHS, num_classes: int = 10) -> List[dict]:
    stem, *stages, head = widths
    f = "features.layers"
    out = [_cbr6(f"{f}.0.layers.0", f"{f}.0.layers.1", 3, stem, 3, STRIDES[0])]
    cin, i = stem, 1
    for (t, n), c, s in zip(SETTINGS, stages, STRIDES[1:]):
        for j in range(n):
            stride, hidden, p = (s if j == 0 else 1), cin * t, f"{f}.{i}.conv.layers"
            convs = [] if t == 1 else [_cbr6(f"{p}.0.layers.0", f"{p}.0.layers.1", cin, hidden, 1)]
            d = len(convs)
            convs += [
                _cbr6(f"{p}.{d}.layers.0", f"{p}.{d}.layers.1", hidden, hidden, 3, stride, hidden),
                conv_bn(f"{p}.{d + 1}", f"{p}.{d + 2}", hidden, c, 1, bias=False, relu=False),
            ]
            if stride == 1 and cin == c:
                out.append(dict(kind="block", key=f"{f}.{i}", residual=convs, shortcut=None,
                                relu=False))
            else:
                out += convs
            cin, i = c, i + 1
    out.append(_cbr6(f"{f}.{i}.layers.0", f"{f}.{i}.layers.1", cin, head, 1))
    return out + [dict(kind="gap"), dict(kind="fc", key="classifier", cin=head,
                                         cout=num_classes)]


class Net(IaoNet):
    """:class:`..iao.IaoNet` with MobileNetV2's two departures from the
    records it knows: ReLU6 (``relu6``) and the linear bottleneck's add
    (``relu`` False on a block)."""

    def _conv_bn(self, c: dict, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = super()._conv_bn(c, x, train)
        return torch.clamp_max(y, 6.0) if c.get("relu6") else y

    def _block(self, op: dict, x: torch.Tensor, train: bool) -> torch.Tensor:
        if op.get("relu", True):
            return super()._block(op, x, train)
        r = x
        for c in op["residual"]:
            r = self._conv_bn(c, r, train)
        qa, qb = self._aq(op["key"] + ".res"), self._aq(op["key"] + ".short")
        union = self._aq(op["key"] + ".add")
        if train:
            qa.observe(r)
            qb.observe(x)
            union.min = torch.minimum(qa.min, qb.min)
            union.max = torch.maximum(qa.max, qb.max)
        return self._epilogue(union(r) + union(x), train)
