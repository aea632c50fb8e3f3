"""Base modules of the port."""

from .modules import Linear

__all__ = ["Linear"]
