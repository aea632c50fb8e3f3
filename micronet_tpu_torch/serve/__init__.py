"""Continuous-batching serving loop and token sampling."""

from .scheduler import Request, ServeLoop

__all__ = ["Request", "ServeLoop"]
