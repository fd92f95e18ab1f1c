"""Graph embeddings on the card — the port of the JAX package's ``graph/``
(deeplearning4j-graph).

In-memory graph API, random-walk iterators, and DeepWalk and Node2Vec built
on the shared SequenceVectors skip-gram trainer (DeepWalk: hierarchical
softmax over a degree-based Huffman tree, GraphHuffman parity).
"""

from .graph import Edge, Graph, load_delimited_edges, load_weighted_edges
from .walks import RandomWalkIterator, WeightedRandomWalkIterator
from .deepwalk import DeepWalk
from .node2vec import Node2Vec

__all__ = ["Edge", "Graph", "DeepWalk", "Node2Vec", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "load_delimited_edges",
           "load_weighted_edges"]
