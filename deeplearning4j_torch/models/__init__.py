"""Model zoo of the port (so far: LeNet, SimpleCNN, VGG16, VGG19,
ResNet50, BertBase, CausalLM, TextGenerationLSTM and GravesLSTMCharRNN)."""

from .cnn import VGG16, VGG19, LeNet, ResNet50, SimpleCNN
from .rnn import GravesLSTMCharRNN, TextGenerationLSTM
from .transformer import BertBase, CausalLM
from .zoo import ZOO_REGISTRY, ZooModel, register_model

__all__ = ["BertBase", "CausalLM", "GravesLSTMCharRNN", "LeNet", "ResNet50",
           "SimpleCNN", "TextGenerationLSTM", "VGG16", "VGG19", "ZOO_REGISTRY",
           "ZooModel", "register_model"]
