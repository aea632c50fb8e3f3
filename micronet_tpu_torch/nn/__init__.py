"""The layer system of the port: functional ops, base modules, the QAT
layers of the three methods and the ``prepare`` transform."""

from . import functional, qat_dorefa, qat_iao, qat_wbwtab, transform
from .modules import (AdaptiveAvgPool2d, Add, AvgPool2d, BatchNorm2d, Conv2d, ConvTranspose2d,
                      Flatten, Identity, LeakyReLU, Linear, MaxPool2d, ReLU, Sequential, Sigmoid,
                      eval_mode, train_mode)
from .transform import prepare

__all__ = ["functional", "qat_iao", "qat_dorefa", "qat_wbwtab", "transform", "prepare",
           "Conv2d", "ConvTranspose2d", "Linear", "BatchNorm2d", "ReLU", "LeakyReLU", "Sigmoid",
           "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d", "Add", "Identity", "Flatten",
           "Sequential", "train_mode", "eval_mode"]
