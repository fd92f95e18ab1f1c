"""Layer catalog of the port (so far: the CausalLM and BERT stacks, the
zoo CNNs' conv, pooling and BatchNorm layers, the dropout and noise
layers, and the recurrent layers)."""

from .attention import (MultiHeadAttention, PositionalEmbedding,
                        TransformerEncoderBlock, dot_product_attention,
                        rope_rotate)
from .conv import Conv2D, Subsampling2D
from .core import (ActivationLayer, AlphaDropout, Dense, DropoutLayer,
                   EmbeddingSequence, GaussianDropout, GaussianNoise, Output,
                   RnnOutput)
from .norm import BatchNorm, LayerNorm
from .pooling import Flatten, GlobalPooling
from .recurrent import (GRU, LSTM, Bidirectional, GravesLSTM, LastTimeStep,
                        RecurrentLayer, SimpleRnn)

__all__ = ["ActivationLayer", "AlphaDropout", "BatchNorm", "Bidirectional",
           "Conv2D", "Dense", "DropoutLayer", "EmbeddingSequence", "GRU",
           "GaussianDropout", "GaussianNoise", "Flatten", "GlobalPooling",
           "GravesLSTM", "LSTM", "LastTimeStep", "LayerNorm",
           "MultiHeadAttention", "Output", "PositionalEmbedding",
           "RecurrentLayer", "RnnOutput", "SimpleRnn", "Subsampling2D",
           "TransformerEncoderBlock", "dot_product_attention", "rope_rotate"]
