"""Serving-side quantization: weight-only int4/int8 and the int8 KV cache."""
