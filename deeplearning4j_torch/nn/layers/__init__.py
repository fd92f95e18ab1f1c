"""Layer catalog of the port: every layer of the reference's
``nn/layers/{core,conv,norm,pooling,attention,recurrent}`` and
``Yolo2Output`` (``moe``, ``custom`` and the rest of ``special`` are not
ported yet: ROADMAP.md, Queue 1, "Special layers")."""

from .attention import (MultiHeadAttention, PositionalEmbedding,
                        TransformerEncoderBlock, dot_product_attention,
                        rope_rotate)
from .conv import (Conv1D, Conv2D, Cropping1D, Cropping2D, Deconv2D,
                   DepthwiseConv2D, SeparableConv2D, SpaceToBatch,
                   SpaceToDepth, Subsampling1D, Subsampling2D, Upsampling1D,
                   Upsampling2D, ZeroPadding1D, ZeroPadding2D)
from .core import (ActivationLayer, AlphaDropout, CenterLossOutput,
                   CnnLossLayer, Dense, DropoutLayer,
                   ElementWiseMultiplication, Embedding, EmbeddingSequence,
                   GaussianDropout, GaussianNoise, LossLayer, Output, PReLU,
                   RnnLossLayer, RnnOutput)
from .norm import LRN, BatchNorm, LayerNorm, RMSNorm
from .pooling import Flatten, GlobalPooling, Reshape
from .recurrent import (GRU, LSTM, Bidirectional, GravesLSTM, LastTimeStep,
                        RecurrentLayer, SimpleRnn)
from .special import Yolo2Output

__all__ = [
    "ActivationLayer", "AlphaDropout", "BatchNorm", "Bidirectional",
    "CenterLossOutput", "CnnLossLayer", "Conv1D", "Conv2D", "Cropping1D",
    "Cropping2D", "Deconv2D", "Dense", "DepthwiseConv2D", "DropoutLayer",
    "ElementWiseMultiplication", "Embedding", "EmbeddingSequence", "Flatten",
    "GRU", "GaussianDropout", "GaussianNoise", "GlobalPooling", "GravesLSTM",
    "LRN", "LSTM", "LastTimeStep", "LayerNorm", "LossLayer",
    "MultiHeadAttention", "Output", "PReLU", "PositionalEmbedding", "RMSNorm",
    "RecurrentLayer", "Reshape", "RnnLossLayer", "RnnOutput",
    "SeparableConv2D", "SimpleRnn", "SpaceToBatch", "SpaceToDepth",
    "Subsampling1D", "Subsampling2D", "TransformerEncoderBlock",
    "Upsampling1D", "Upsampling2D", "Yolo2Output", "ZeroPadding1D",
    "ZeroPadding2D", "dot_product_attention", "rope_rotate"]
