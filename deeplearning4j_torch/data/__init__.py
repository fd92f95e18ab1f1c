"""Data pipeline of the port (so far: in-memory, prefetching and benchmark
iterators, and the char-RNN corpus)."""

from .datasets import char_rnn_corpus
from .iterators import (ArrayIterator, AsyncIterator, BenchmarkIterator,
                        DataSet, DataSetIterator)

__all__ = ["ArrayIterator", "AsyncIterator", "BenchmarkIterator", "DataSet",
           "DataSetIterator", "char_rnn_corpus"]
