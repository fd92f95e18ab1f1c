"""Layers and containers of the port."""

from . import layers
from .api import LAYER_REGISTRY, Layer, layer_from_dict, register_layer
from .model import (DTYPES, Graph, GraphBuilder, GraphNode, NetConfig,
                    Sequential, SequentialBuilder)
from .vertices import VERTEX_REGISTRY, GraphVertex, vertex_from_dict

__all__ = ["DTYPES", "Graph", "GraphBuilder", "GraphNode", "GraphVertex",
           "LAYER_REGISTRY", "Layer", "NetConfig", "Sequential",
           "SequentialBuilder", "VERTEX_REGISTRY", "layer_from_dict",
           "layers", "register_layer", "vertex_from_dict"]
