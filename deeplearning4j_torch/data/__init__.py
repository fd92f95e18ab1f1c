"""Data pipeline of the port: in-memory, prefetching, benchmark, capped,
repeating and exported-file iterators, ``MultiDataSet``, the normalizers,
the canned datasets (local files or the reference's synthetic replicas),
the char-RNN corpus and synthetic YOLOv2 labels."""

from .datasets import (char_rnn_corpus, load_cifar10, load_iris, load_mnist,
                       mnist_iterator, yolo_labels)
from .iterators import (ArrayIterator, AsyncIterator, BenchmarkIterator,
                        DataSet, DataSetIterator, EarlyTerminationIterator,
                        FileDataSetIterator, MultiDataSet,
                        MultipleEpochsIterator, export_batches,
                        split_iterator)
from .normalizers import (ImageScaler, MinMaxScaler, Normalizer, Standardize,
                          VGG16Preprocessor)

__all__ = ["ArrayIterator", "AsyncIterator", "BenchmarkIterator", "DataSet",
           "DataSetIterator", "EarlyTerminationIterator",
           "FileDataSetIterator", "ImageScaler", "MinMaxScaler",
           "MultiDataSet", "MultipleEpochsIterator", "Normalizer",
           "Standardize", "VGG16Preprocessor", "char_rnn_corpus",
           "export_batches", "load_cifar10", "load_iris", "load_mnist",
           "mnist_iterator", "split_iterator", "yolo_labels"]
