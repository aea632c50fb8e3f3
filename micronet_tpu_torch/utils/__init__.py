"""Utilities of the port: the JSONL metrics sink."""

from .metrics import MetricsLogger

__all__ = ["MetricsLogger"]
