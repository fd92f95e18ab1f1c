"""Layer catalog of the port: every layer of the reference's
``nn/layers/{core,conv,norm,pooling,attention,recurrent,special,custom,moe}``."""

from .attention import (MultiHeadAttention, PositionalEmbedding,
                        TransformerEncoderBlock, dot_product_attention,
                        rope_rotate)
from .conv import (Conv1D, Conv2D, Cropping1D, Cropping2D, Deconv2D,
                   DepthwiseConv2D, SeparableConv2D, SpaceToBatch,
                   SpaceToDepth, Subsampling1D, Subsampling2D, Upsampling1D,
                   Upsampling2D, ZeroPadding1D, ZeroPadding2D)
from .custom import CustomLayer, Lambda
from .core import (ActivationLayer, AlphaDropout, CenterLossOutput,
                   CnnLossLayer, Dense, DropoutLayer,
                   ElementWiseMultiplication, Embedding, EmbeddingSequence,
                   GaussianDropout, GaussianNoise, LossLayer, Output, PReLU,
                   RnnLossLayer, RnnOutput)
from .moe import MoE, MoETransformerBlock
from .norm import LRN, BatchNorm, LayerNorm, RMSNorm
from .pooling import Flatten, GlobalPooling, Reshape
from .recurrent import (GRU, LSTM, Bidirectional, GravesLSTM, LastTimeStep,
                        RecurrentLayer, SimpleRnn)
from .special import VAE, AutoEncoder, Frozen, Yolo2Output

__all__ = [
    "ActivationLayer", "AlphaDropout", "AutoEncoder", "BatchNorm",
    "Bidirectional", "CenterLossOutput", "CnnLossLayer", "Conv1D", "Conv2D",
    "Cropping1D", "Cropping2D", "CustomLayer", "Deconv2D", "Dense",
    "DepthwiseConv2D", "DropoutLayer", "ElementWiseMultiplication",
    "Embedding", "EmbeddingSequence", "Flatten", "Frozen", "GRU",
    "GaussianDropout", "GaussianNoise", "GlobalPooling", "GravesLSTM", "LRN",
    "LSTM", "Lambda", "LastTimeStep", "LayerNorm", "LossLayer", "MoE",
    "MoETransformerBlock", "MultiHeadAttention", "Output", "PReLU",
    "PositionalEmbedding", "RMSNorm", "RecurrentLayer", "Reshape", "RnnLossLayer", "RnnOutput",
    "SeparableConv2D", "SimpleRnn", "SpaceToBatch", "SpaceToDepth",
    "Subsampling1D", "Subsampling2D", "TransformerEncoderBlock",
    "Upsampling1D", "Upsampling2D", "VAE", "Yolo2Output", "ZeroPadding1D",
    "ZeroPadding2D", "dot_product_attention", "rope_rotate"]
