"""Typed quantization config: the counterpart of
``micronet_tpu/quant/config.py``, field for field.

The axes are the feature matrix of ``prepare(...)``: every IAO flag plus
the DoReFa and wbwtab knobs, so one object configures all three flavours.
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
      calibration with the percentile histogram or the KL (entropy)
      observers (``quant/observers.py``, ``quant/calibrate.py``).
    - ``quant_inference``: weights are pre-quantized; skip the weight
      fake-quant at run time.
    - ``act_codes``: quantized convs and linears (IAO and DoReFa) read
      the activation codes as bf16 operands and fold the scale and zero
      point into the epilogue. ``"auto"`` takes it for a CUDA input and
      keeps the exact f32 composition on the CPU; ``"on"``/``"off"``
      force it (``"on"`` on the CPU runs f32 codes). Never above 8 bits or
      under PTQ.
    - ``bn_stats``: the ``bn_fuse`` statistics conv in bf16 (``"on"``, on
      every device), or none (``"acc"``: the batch statistics from the
      quantized conv's accumulator; per-channel symmetric weights only,
      other configs keep the statistics conv). ``"auto"`` takes acc on
      CUDA where it applies, else the bf16 statistics conv on CUDA, and
      the exact f32 path on the CPU. Pin ``act_codes="off",
      bn_stats="off"`` for the exact path on the card.

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
