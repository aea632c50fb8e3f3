"""The yardstick: the work a network requires, counted from its layer
shapes (never from the program's kernels), and the published peaks of
the card it is divided by.

A conv's multiply-accumulates honour its groups: ``H_out * W_out * C_out
* (C_in / groups) * k * k`` an image, whatever block-diagonal GEMM an
implementation runs. A training step counts three times the forward
(forward, data gradient, weight gradient), with nothing recomputed.
"""

from __future__ import annotations

from typing import Dict, List

from .reference import arch

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAKS: Dict[str, float] = {
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def layers(ops: List[dict], size: int = 32) -> List[dict]:
    """Each conv and linear of ``ops`` with its input and output size:
    ``cin``, ``cout``, ``k``, ``groups``, ``h_in``, ``h_out``, ``macs`` (an
    image, groups honoured) and ``dense_macs`` (the same conv as one dense
    GEMM over a block-diagonal weight)."""
    out = []
    h = size

    def conv(c, h_in):
        h_out = (h_in + 2 * c["pad"] - c["k"]) // c["stride"] + 1
        per = h_out * h_out * c["cout"] * c["k"] * c["k"]
        out.append(dict(name=c["conv"], cin=c["cin"], cout=c["cout"], k=c["k"],
                        groups=c["groups"], h_in=h_in, h_out=h_out,
                        macs=per * (c["cin"] // c["groups"]), dense_macs=per * c["cin"]))
        return h_out

    for op in ops:
        kind = op["kind"]
        if kind == "conv_bn":
            h = conv(op, h)
        elif kind in ("maxpool", "avgpool"):
            h = (h - op["k"]) // op["stride"] + 1
        elif kind == "block":
            h_in = h
            for c in op["residual"]:
                h = conv(c, h)
            if op["shortcut"]:
                conv(op["shortcut"], h_in)
        elif kind == "gap":
            h = 1
        elif kind == "fc":
            out.append(dict(name=op["key"], cin=op["cin"], cout=op["cout"], k=1, groups=1,
                            h_in=1, h_out=1, macs=op["cin"] * op["cout"],
                            dense_macs=op["cin"] * op["cout"]))
    return out


def forward_macs(ops: List[dict]) -> int:
    """Multiply-accumulates of one image's forward, groups honoured."""
    return sum(layer["macs"] for layer in layers(ops))


def train_flops_per_image(ops: List[dict]) -> int:
    """Operations of one image's training step: 3 x the forward's 2 x MACs."""
    return 3 * 2 * forward_macs(ops)


def engine_gemm_bound_s(ops: List[dict], batch: int) -> float:
    """The least time the card could take over the GEMMs of one engine
    forward at ``batch``: per layer the larger of its operations over the
    peak of its precision and its bytes over the memory rate. The bytes
    are the codes in once (a byte each; four for the first layer, which
    the engine runs on dequantized f32 values), the weights once (a byte
    each, four in f32) and the output once (int32 accumulators, f32 for
    the first layer and the classifier). A layer with fewer than 8 input
    channels a group and one group is the first layer: f32."""
    total = 0.0
    for layer in layers(ops):
        f32 = layer["groups"] == 1 and layer["cin"] < 8
        width = 4 if f32 else 1
        ops_n = 2 * layer["macs"] * batch
        peak = PEAKS["f32_flops"] if f32 else PEAKS["int8_ops"]
        n_in = batch * layer["cin"] * layer["h_in"] ** 2 * width
        n_w = layer["cout"] * (layer["cin"] // layer["groups"]) * layer["k"] ** 2 * width
        n_out = batch * layer["cout"] * layer["h_out"] ** 2 * 4
        total += max(ops_n / peak, (n_in + n_w + n_out) / PEAKS["hbm_bytes_per_s"])
    return total


def arch_ops(config: dict) -> List[dict]:
    """The op list a configuration names (``arch`` and optional ``widths``)."""
    return arch.build(config["arch"], config.get("widths"))
