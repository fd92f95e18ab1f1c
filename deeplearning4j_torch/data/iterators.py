"""Dataset iterators — counterpart of ``deeplearning4j_tpu/data/iterators.py``
(``DataSet``, ``MultiDataSet``, ``DataSetIterator``, ``ArrayIterator``,
``AsyncIterator``, ``BenchmarkIterator``, ``EarlyTerminationIterator``,
``MultipleEpochsIterator``, ``export_batches`` with
``FileDataSetIterator``, and ``split_iterator``).

A ``DataSet`` is a (features, labels, masks) record of host arrays (numpy)
or tensors; iterators are plain Python iterables. ``AsyncIterator``
prefetches batches on a background thread, the reference's
AsyncDataSetIterator. It leaves them on the host: the trainer moves each
batch to the device in its step, on the training thread's CUDA stream.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class DataSet:
    """ND4J DataSet equivalent: features, labels, optional masks."""

    features: Any
    labels: Any
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    @property
    def num_examples(self) -> int:
        f = self.features
        return int(f.shape[0] if hasattr(f, "shape") else np.asarray(f).shape[0])


@dataclass
class MultiDataSet:
    """ND4J MultiDataSet: several feature and label arrays (a Graph's
    inputs by position, its outputs' labels by position)."""

    features: List[Any]
    labels: List[Any]
    features_masks: Optional[List[Any]] = None
    labels_masks: Optional[List[Any]] = None

    @property
    def num_examples(self) -> int:
        f = self.features[0]
        return int(f.shape[0] if hasattr(f, "shape") else np.asarray(f).shape[0])


class DataSetIterator:
    """Base protocol; DL4J DataSetIterator parity (reset/batch size)."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    #: minibatch size; subclasses set an instance attribute or override
    batch_size: int = -1


class ArrayIterator(DataSetIterator):
    """Iterate minibatches over in-memory arrays (ListDataSetIterator
    parity); ``shuffle`` draws from ``np.random.default_rng(seed)``."""

    def __init__(self, features, labels, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0, features_mask=None, labels_mask=None,
                 drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = (np.asarray(features_mask)
                              if features_mask is not None else None)
        self.labels_mask = (np.asarray(labels_mask)
                            if labels_mask is not None else None)
        self._batch = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    @property
    def batch_size(self):
        return self._batch

    def __len__(self):
        n = self.features.shape[0]
        return n // self._batch if self.drop_last else -(-n // self._batch)

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = n - n % self._batch if self.drop_last else n
        for i in range(0, end, self._batch):
            sl = idx[i: i + self._batch]
            yield DataSet(
                self.features[sl], self.labels[sl],
                self.features_mask[sl] if self.features_mask is not None else None,
                self.labels_mask[sl] if self.labels_mask is not None else None,
            )


class BenchmarkIterator(DataSetIterator):
    """BenchmarkDataSetIterator.java — the same random batch served
    ``num_batches`` times, isolating compute from data loading. Features
    are standard normal and labels one-hot, drawn from
    ``np.random.default_rng(seed)`` in the reference's order, so both
    packages serve the same batch."""

    def __init__(self, feature_shape: Sequence[int], num_classes: int,
                 batch_size: int, num_batches: int, seed: int = 0,
                 dtype=np.float32):
        rng = np.random.default_rng(seed)
        self._features = rng.standard_normal(
            (batch_size, *feature_shape)).astype(dtype)
        labels = np.zeros((batch_size, num_classes), dtype)
        labels[np.arange(batch_size),
               rng.integers(0, num_classes, batch_size)] = 1
        self._labels = labels
        self._batch = batch_size
        self.num_batches = num_batches

    @property
    def batch_size(self):
        return self._batch

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        ds = DataSet(self._features, self._labels)
        for _ in range(self.num_batches):
            yield ds


class AsyncIterator(DataSetIterator):
    """Background-thread prefetch over a bounded queue
    (AsyncDataSetIterator). An exception in the producer is re-raised in
    the consumer after the batches before it."""

    _SENTINEL = object()

    def __init__(self, base: Iterable[DataSet], queue_size: int = 4):
        self.base = base
        self.queue_size = queue_size

    @property
    def batch_size(self):
        return getattr(self.base, "batch_size", -1)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        err: List[BaseException] = []
        stop = threading.Event()

        def worker():
            try:
                for ds in self.base:
                    while not stop.is_set():
                        try:
                            q.put(ds, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # handed to the consumer, raised there
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True, name="dl4j-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                yield item
        finally:
            # a consumer that stops early (an exception in its step) must
            # not leave the producer blocked on a full queue
            stop.set()
            t.join(timeout=5)
        if err:
            raise err[0]


class EarlyTerminationIterator(DataSetIterator):
    """EarlyTerminationDataSetIterator.java — at most ``max_batches``
    batches of the base iterator."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self.base = base
        self.max_batches = max_batches

    @property
    def batch_size(self):
        return self.base.batch_size

    def reset(self):
        self.base.reset()

    def __iter__(self):
        for i, ds in enumerate(self.base):
            if i >= self.max_batches:
                break
            yield ds


class MultipleEpochsIterator(DataSetIterator):
    """MultipleEpochsIterator.java — the base iterator ``epochs`` times,
    reset before each pass."""

    def __init__(self, base: DataSetIterator, epochs: int):
        self.base = base
        self.epochs = epochs

    @property
    def batch_size(self):
        return self.base.batch_size

    def __iter__(self):
        for _ in range(self.epochs):
            if hasattr(self.base, "reset"):
                self.base.reset()
            yield from self.base


def _host(a):
    """A batch array as numpy (a tensor is copied to the host)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def export_batches(iterator: DataSetIterator, directory: str,
                   prefix: str = "dataset") -> int:
    """Write an iterator's batches as numbered ``{prefix}_NNNNNN.npz``
    files (the reference's layout: ``features``, ``labels`` and the masks
    present), after removing the files an earlier export of this prefix
    left; returns the number written."""
    os.makedirs(directory, exist_ok=True)
    for stale in _batch_files(directory, prefix):
        os.remove(stale)
    n = 0
    for ds in iterator:
        arrs = {"features": _host(ds.features), "labels": _host(ds.labels)}
        if ds.features_mask is not None:
            arrs["features_mask"] = _host(ds.features_mask)
        if ds.labels_mask is not None:
            arrs["labels_mask"] = _host(ds.labels_mask)
        np.savez(os.path.join(directory, f"{prefix}_{n:06d}.npz"), **arrs)
        n += 1
    if hasattr(iterator, "reset"):
        iterator.reset()
    return n


def _batch_files(directory: str, prefix: str) -> List[str]:
    """The files ``export_batches`` writes for exactly this prefix."""
    pat = re.compile(re.escape(prefix) + r"_\d{6}\.npz$")
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(os.path.join(directory, f) for f in names if pat.fullmatch(f))


class FileDataSetIterator(DataSetIterator):
    """ExistingMiniBatchDataSetIterator.java — the batches of an export
    directory, in file order or shuffled per epoch from
    ``np.random.default_rng(seed)``; ``shard=(rank, world)`` takes every
    world-th file from ``rank``."""

    def __init__(self, directory: str, prefix: str = "dataset",
                 shuffle: bool = False, seed: int = 0,
                 shard: Optional[Tuple[int, int]] = None):
        if not os.path.isdir(directory):
            raise FileNotFoundError(f"export directory does not exist: "
                                    f"{directory}")
        self.files = _batch_files(directory, prefix)
        if not self.files:
            raise ValueError(
                f"no exported batches matching '{prefix}_NNNNNN.npz' in "
                f"{directory} — check the prefix or run export_batches first")
        if shard is not None:
            rank, world = shard
            self.files = self.files[rank::world]
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        order = np.arange(len(self.files))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in order:
            with np.load(self.files[i]) as z:
                yield DataSet(z["features"], z["labels"],
                              z["features_mask"] if "features_mask" in z else None,
                              z["labels_mask"] if "labels_mask" in z else None)


def split_iterator(features, labels, fraction_train: float,
                   batch_size: int = 32, seed: int = 0, shuffle: bool = True
                   ) -> Tuple[ArrayIterator, ArrayIterator]:
    """DataSetIteratorSplitter: rows shuffled by
    ``np.random.default_rng(seed)``, the first ``fraction_train`` of them
    to a training iterator (shuffled per epoch when ``shuffle``), the rest
    to a test iterator."""
    f, lab = np.asarray(features), np.asarray(labels)
    idx = np.arange(f.shape[0])
    np.random.default_rng(seed).shuffle(idx)
    cut = int(f.shape[0] * fraction_train)
    tr, te = idx[:cut], idx[cut:]
    return (ArrayIterator(f[tr], lab[tr], batch_size, shuffle=shuffle,
                          seed=seed),
            ArrayIterator(f[te], lab[te], batch_size))
