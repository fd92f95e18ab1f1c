"""Nearest neighbours and clustering — the port of the JAX package's
``knn/`` (deeplearning4j-nearestneighbors-parent): the brute-force scan on
the card, the VP, KD and SP trees (host structures, as in the reference),
random-projection LSH, k-means and the clustering framework (their passes
on the card), and the k-NN REST server and client."""

from .brute import BruteForceKNN
from .client import NearestNeighborsClient
from .clustering import (BaseClusteringAlgorithm, ClusteringOptimizationType,
                         ClusterSet, ClusterSetInfo, ConvergenceCondition,
                         FixedClusterCountStrategy,
                         FixedIterationCountCondition, IterationHistory,
                         KMeansClustering, OptimisationStrategy,
                         VarianceVariationCondition)
from .kdtree import KDTree
from .kmeans import KMeans
from .lsh import RandomProjectionLSH
from .server import NearestNeighborsServer
from .sptree import QuadTree, SPTree
from .vptree import VPTree

__all__ = ["BaseClusteringAlgorithm", "BruteForceKNN",
           "ClusterSet", "ClusterSetInfo", "ClusteringOptimizationType",
           "ConvergenceCondition", "FixedClusterCountStrategy",
           "FixedIterationCountCondition", "IterationHistory", "KDTree",
           "KMeans", "KMeansClustering", "NearestNeighborsClient",
           "NearestNeighborsServer", "OptimisationStrategy", "QuadTree",
           "RandomProjectionLSH", "SPTree", "VPTree",
           "VarianceVariationCondition"]
