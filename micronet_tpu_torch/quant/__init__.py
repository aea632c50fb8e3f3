"""Quantization core of the port: rounding and STE, observers, quantizers
(IAO), DoReFa, wbwtab; ``weight_only``, ``kv_cache`` and ``paged_kv`` for
serving and ``calibrate`` for KL entropy calibration are modules of their
own."""

from . import dorefa, wbwtab
from .observers import (HistogramState, MinMaxState, ema_minmax_update, histogram_update,
                        init_histogram_state, init_minmax_state, minmax_update, percentile_absmax)
from .quantizers import (FLOAT32_EPS, asymmetric_qparams, dequantize_int, fake_quant, quant_range,
                         quantize_int, symmetric_qparams)
from .rounding import binary_act, binary_weight, clip_ste_round, round_half_away, ste_round, ternary

__all__ = ["dorefa", "wbwtab", "MinMaxState", "HistogramState", "init_minmax_state",
           "init_histogram_state", "minmax_update", "ema_minmax_update", "histogram_update",
           "percentile_absmax", "FLOAT32_EPS", "quant_range", "symmetric_qparams",
           "asymmetric_qparams", "fake_quant", "quantize_int", "dequantize_int", "round_half_away",
           "ste_round", "clip_ste_round", "binary_act", "binary_weight", "ternary"]
