"""The depthwise convs' share of their roofline: the least time the card
could take over the network's depthwise layers (:func:`bound_s`, from the
layer shapes) over ``engine_dwconv_ms``, the device time of the depthwise
route."""

from typing import List

from portbench import harness, work

_dwconv_ms = harness.load_module("layers", "engine_dwconv_ms").read


def is_depthwise(layer: dict) -> bool:
    """A 3 x 3 conv with groups = C_in = C_out > 1."""
    return layer["groups"] > 1 and layer["groups"] == layer["cin"] == layer["cout"] \
        and layer["k"] == 3


def bound_s(ops: List[dict], batch: int) -> float:
    """Per depthwise layer the larger of its operations (2 x MACs x batch)
    over the int8 peak and its bytes over the memory rate, summed. The
    bytes are int8 codes in once, the weights once and int8 codes out
    once, whatever the program writes."""
    total = 0.0
    for layer in filter(is_depthwise, work.layers(ops)):
        ops_n = 2 * layer["macs"] * batch
        codes = layer["cin"] * layer["h_in"] ** 2 + layer["cout"] * layer["h_out"] ** 2
        n_bytes = batch * codes + layer["cout"] * layer["k"] ** 2
        total += max(ops_n / work.PEAKS["int8_ops"], n_bytes / work.PEAKS["hbm_bytes_per_s"])
    return total


def read(run):
    ms = _dwconv_ms(run)
    if ms is None:
        return None
    return 100.0 * bound_s(work.arch_ops(run.config), run.window["batch"]) * 1e3 / ms
