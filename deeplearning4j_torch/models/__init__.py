"""Model zoo of the port (so far: CausalLM and ResNet50)."""

from .cnn import ResNet50
from .transformer import CausalLM
from .zoo import ZOO_REGISTRY, ZooModel, register_model

__all__ = ["CausalLM", "ResNet50", "ZOO_REGISTRY", "ZooModel",
           "register_model"]
