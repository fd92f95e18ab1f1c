"""Model zoo of the port: the twelve CNNs, BertBase, CausalLM,
TextGenerationLSTM and GravesLSTMCharRNN."""

from .cnn import (VGG16, VGG19, YOLO2, AlexNet, Darknet19, FaceNetNN4Small2,
                  GoogLeNet, InceptionResNetV1, LeNet, ResNet50, SimpleCNN,
                  TinyYOLO)
from .rnn import GravesLSTMCharRNN, TextGenerationLSTM
from .transformer import BertBase, CausalLM
from .zoo import ZOO_REGISTRY, ZooModel, model_by_name, register_model

__all__ = ["AlexNet", "BertBase", "CausalLM", "Darknet19", "FaceNetNN4Small2",
           "GoogLeNet", "GravesLSTMCharRNN", "InceptionResNetV1", "LeNet",
           "ResNet50", "SimpleCNN", "TextGenerationLSTM", "TinyYOLO", "VGG16",
           "VGG19", "YOLO2", "ZOO_REGISTRY", "ZooModel", "model_by_name",
           "register_model"]
