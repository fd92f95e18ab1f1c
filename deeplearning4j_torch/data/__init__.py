"""Data pipeline of the port (so far: in-memory, prefetching and benchmark
iterators)."""

from .iterators import (ArrayIterator, AsyncIterator, BenchmarkIterator,
                        DataSet, DataSetIterator)

__all__ = ["ArrayIterator", "AsyncIterator", "BenchmarkIterator", "DataSet",
           "DataSetIterator"]
