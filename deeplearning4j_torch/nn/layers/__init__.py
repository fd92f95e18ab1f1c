"""Layer catalog of the port (so far: the CausalLM and BERT stacks, the
zoo CNNs' conv, pooling and BatchNorm layers, and the dropout and noise
layers)."""

from .attention import (MultiHeadAttention, PositionalEmbedding,
                        TransformerEncoderBlock, dot_product_attention,
                        rope_rotate)
from .conv import Conv2D, Subsampling2D
from .core import (ActivationLayer, AlphaDropout, Dense, DropoutLayer,
                   EmbeddingSequence, GaussianDropout, GaussianNoise, Output,
                   RnnOutput)
from .norm import BatchNorm, LayerNorm
from .pooling import Flatten, GlobalPooling

__all__ = ["ActivationLayer", "AlphaDropout", "BatchNorm", "Conv2D", "Dense",
           "DropoutLayer", "EmbeddingSequence", "GaussianDropout",
           "GaussianNoise", "Flatten", "GlobalPooling", "LayerNorm",
           "MultiHeadAttention", "Output", "PositionalEmbedding", "RnnOutput",
           "Subsampling2D", "TransformerEncoderBlock",
           "dot_product_attention", "rope_rotate"]
