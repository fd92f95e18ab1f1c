"""Data pipeline of the port (so far: in-memory, prefetching and benchmark
iterators, the char-RNN corpus and synthetic YOLOv2 labels)."""

from .datasets import char_rnn_corpus, yolo_labels
from .iterators import (ArrayIterator, AsyncIterator, BenchmarkIterator,
                        DataSet, DataSetIterator)

__all__ = ["ArrayIterator", "AsyncIterator", "BenchmarkIterator", "DataSet",
           "DataSetIterator", "char_rnn_corpus", "yolo_labels"]
