"""Typed quantization config: the counterpart of
``micronet_tpu/quant/config.py``, field for field.

The axes are the feature matrix of ``prepare(...)``: every IAO flag plus
the DoReFa and wbwtab knobs, so one object configures all three flavours
(IAO and wbwtab are ported so far).
"""

from __future__ import annotations

import dataclasses

__all__ = ["QuantConfig"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration for :func:`micronet_tpu_torch.nn.transform.prepare`.

    IAO axes:

    - ``a_bits`` / ``w_bits``: activation / weight bit-widths; 32 = float
      passthrough.
    - ``first_layer_*`` / ``last_layer_*``: bit overrides for the first and
      last quantizable conv/linear (0 = none), so the input stem and the
      classifier can stay wider while the body runs narrow.
    - ``q_type``: 0 symmetric (signed), 1 asymmetric (unsigned).
    - ``q_level``: 0 per-channel weights, 1 per-layer.
    - ``weight_observer``: 0 cumulative MinMax, 1 EMA MinMax.
    - ``bn_fuse``: in-training Conv+BN fusion (``QuantBNFuseConv2d``).
    - ``bn_fuse_calib``: fuse weights with running stats and correct the
      output back to batch statistics.
    - ``pretrained_model``: running BN stats are pre-seeded, so the first
      training batch does not overwrite them.
    - ``qaft``: observers, qparams and BN statistics frozen.
    - ``ptq`` / ``percentile`` / ``ptq_observer``: post-training
      calibration with histogram or KL observers (not ported yet).
    - ``quant_inference``: weights are pre-quantized; skip the weight
      fake-quant at run time.
    - ``act_codes`` / ``bn_stats``: training lowerings of the JAX package
      for its accelerator. In the port every value resolves to the exact
      f32 composition on every device; the H100 lowerings are later work,
      each to be held against this exact path.

    DoReFa uses ``a_bits``/``w_bits``/``quant_inference`` only. wbwtab:
    ``W`` 2 = binary, 3 = ternary, 32 = float; ``A`` 2 = binary, 32 = relu.
    """

    a_bits: int = 8
    w_bits: int = 8
    first_layer_a_bits: int = 0
    first_layer_w_bits: int = 0
    last_layer_a_bits: int = 0
    last_layer_w_bits: int = 0
    q_type: int = 0
    q_level: int = 0
    weight_observer: int = 0
    bn_fuse: bool = False
    bn_fuse_calib: bool = False
    pretrained_model: bool = False
    qaft: bool = False
    ptq: bool = False
    percentile: float = 0.9999
    ptq_observer: str = "percentile"  # "percentile" | "kl"
    quant_inference: bool = False
    act_codes: str = "auto"  # "auto" | "on" | "off"
    bn_stats: str = "auto"  # "auto" | "on" | "off" | "acc"
    # wbwtab
    W: int = 2
    A: int = 2

    @property
    def symmetric(self) -> bool:
        return self.q_type == 0
