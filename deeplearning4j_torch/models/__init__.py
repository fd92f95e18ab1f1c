"""Model zoo of the port (so far: LeNet, SimpleCNN, VGG16, VGG19,
ResNet50, BertBase and CausalLM)."""

from .cnn import VGG16, VGG19, LeNet, ResNet50, SimpleCNN
from .transformer import BertBase, CausalLM
from .zoo import ZOO_REGISTRY, ZooModel, register_model

__all__ = ["BertBase", "CausalLM", "LeNet", "ResNet50", "SimpleCNN", "VGG16",
           "VGG19", "ZOO_REGISTRY", "ZooModel", "register_model"]
