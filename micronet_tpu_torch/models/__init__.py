"""Model families of the port: NIN, NIN-GC, the CIFAR ResNets, LeNet and
MobileNetV2 (its factory ``mobilenet_v2`` shadows the module of that
name here; import the module as ``models.mobilenet_v2`` through
``from ... import``), and the LLM serving families (Llama; the
TinyDecoder in ``models.tiny_decoder``)."""

from . import lenet, nin, nin_gc, resnet
from .lenet import LeNet
from .llama import Llama, LlamaConfig, llama3_8b, llama_tiny, quantize_llama
from .mobilenet_v2 import MobileNetV2, mobilenet_v2
from .resnet import resnet18, resnet34, resnet50, resnet101, resnet152

__all__ = ["nin", "nin_gc", "resnet", "lenet", "LeNet", "Llama", "LlamaConfig", "llama3_8b",
           "llama_tiny", "quantize_llama", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "MobileNetV2", "mobilenet_v2"]
