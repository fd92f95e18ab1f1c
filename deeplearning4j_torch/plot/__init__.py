"""Visualization on the card — the port of the JAX package's ``plot/``
(deeplearning4j-core ``plot/``): exact and Barnes-Hut t-SNE."""

from .tsne import BarnesHutTsne, Tsne

__all__ = ["BarnesHutTsne", "Tsne"]
