"""Model families of the port."""

from .lenet import LeNet

__all__ = ["LeNet"]
