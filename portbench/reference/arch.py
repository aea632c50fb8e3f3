"""The benchmark's networks as plain layer lists: what the reference runs,
what the work counter counts and what the weight maker fills.

Each network is a list of op records (dicts), made by
``archs/<name>.py``. Parameter and buffer keys follow the published
module trees (micronet's ``models/nin_gc`` and ``models/resnet``), which
are also the key names of the float models under test, so one weight
dict loads into both sides.

Op kinds:

- ``conv_bn``: convolution (OIHW weight, ``groups``), batch norm, then a
  ReLU when ``relu``; ``shuffle`` > 0 shuffles the input channels over that
  many groups first;
- ``maxpool``, ``avgpool``: ``k`` x ``k`` windows, stride ``stride``;
- ``block``: a residual block, two ``conv_bn`` on the residual path, an
  optional ``conv_bn`` shortcut, the add, then a ReLU;
- ``gap``: the global average pool;
- ``fc``: a linear layer whose weight is stored (in, out).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence, Tuple


def conv_bn(conv_key: str, bn_key: str, cin: int, cout: int, k: int, stride: int = 1,
            pad: int = 0, groups: int = 1, bias: bool = True, relu: bool = True,
            shuffle: int = 0) -> dict:
    """A ``conv_bn`` op record."""
    return dict(kind="conv_bn", conv=conv_key, bn=bn_key, cin=cin, cout=cout, k=k,
                stride=stride, pad=pad, groups=groups, bias=bias, relu=relu, shuffle=shuffle)


def build(arch: str, widths: Optional[Sequence[int]] = None) -> List[dict]:
    """The op list of ``arch``, from ``archs/<arch>.py``'s ``ops(widths)``
    (``widths`` None: the published ones)."""
    mod = importlib.import_module(f"{__package__}.archs.{arch}")
    return mod.ops() if widths is None else mod.ops(widths=tuple(widths))


def conv_layers(ops: List[dict]) -> List[dict]:
    """Every ``conv_bn`` record in execution order (residual path before
    the shortcut, as the block runs them)."""
    out = []
    for op in ops:
        if op["kind"] == "conv_bn":
            out.append(op)
        elif op["kind"] == "block":
            out += op["residual"] + ([op["shortcut"]] if op["shortcut"] else [])
    return out


def param_shapes(ops: List[dict]) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """``key -> (shape, role, fan_in)`` of every float parameter and BN
    buffer; the role says how the weight maker fills it (``weight``,
    ``bias``, ``gamma``, ``beta``, ``mean``, ``var``)."""
    out: Dict[str, Tuple[Tuple[int, ...], str, int]] = {}
    for c in conv_layers(ops):
        fan_in = c["cin"] // c["groups"] * c["k"] * c["k"]
        out[f"{c['conv']}.weight"] = ((c["cout"], c["cin"] // c["groups"], c["k"], c["k"]),
                                      "weight", fan_in)
        if c["bias"]:
            out[f"{c['conv']}.bias"] = ((c["cout"],), "bias", fan_in)
        for name, role in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"),
                           ("running_var", "var")):
            out[f"{c['bn']}.{name}"] = ((c["cout"],), role, fan_in)
    for op in ops:
        if op["kind"] == "fc":
            out[f"{op['key']}.weight"] = ((op["cin"], op["cout"]), "weight", op["cin"])
            out[f"{op['key']}.bias"] = ((op["cout"],), "bias", op["cin"])
    return out
