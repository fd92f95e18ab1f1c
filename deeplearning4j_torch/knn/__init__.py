"""Nearest neighbours on the card — the port of the JAX package's ``knn/``
brute-force scan, its REST server and client. The tree, LSH and clustering
modules of the reference are not ported yet."""

from .brute import BruteForceKNN
from .client import NearestNeighborsClient
from .server import NearestNeighborsServer

__all__ = ["BruteForceKNN", "NearestNeighborsClient", "NearestNeighborsServer"]
