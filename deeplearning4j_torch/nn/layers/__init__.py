"""Layer catalog of the port (so far: the CausalLM stack and the
ResNet-50 graph's conv, pooling and BatchNorm layers)."""

from .attention import (MultiHeadAttention, PositionalEmbedding,
                        TransformerEncoderBlock, dot_product_attention,
                        rope_rotate)
from .conv import Conv2D, Subsampling2D
from .core import ActivationLayer, Dense, EmbeddingSequence, Output, RnnOutput
from .norm import BatchNorm, LayerNorm
from .pooling import Flatten, GlobalPooling

__all__ = ["ActivationLayer", "BatchNorm", "Conv2D", "Dense",
           "EmbeddingSequence", "Flatten", "GlobalPooling", "LayerNorm",
           "MultiHeadAttention", "Output", "PositionalEmbedding", "RnnOutput",
           "Subsampling2D", "TransformerEncoderBlock",
           "dot_product_attention", "rope_rotate"]
