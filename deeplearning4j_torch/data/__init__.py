"""Data pipeline of the port (this slice: in-memory and prefetching
iterators)."""

from .iterators import ArrayIterator, AsyncIterator, DataSet, DataSetIterator

__all__ = ["ArrayIterator", "AsyncIterator", "DataSet", "DataSetIterator"]
