"""Modules, QAT layers and the ``prepare`` transform of the port."""

from .modules import Linear, eval_mode, train_mode
from .transform import prepare

__all__ = ["Linear", "eval_mode", "prepare", "train_mode"]
