"""Batch staging: host arrays to the training device.

On the card a host array goes through a pinned buffer and a
``non_blocking`` copy on a copy stream of the stager's own; the stream
that will use the batch (the current one) waits on an event recorded
after the copy, so the host never blocks on the copy and the step never
reads a batch before it has landed. Each (shape, dtype) has two pinned
buffers used in turn: before the host writes one, it waits for the copy
that last read it, which the copy stream finishes without waiting on any
step. The device tensor is allocated on the copy stream and marked as
used by the current stream (``record_stream``), so the caching allocator
hands its memory out again only after that use. A tensor already on the
device passes through; on the CPU an array becomes a tensor with
``torch.as_tensor``, as before staging existed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_DEPTH = 2  # pinned buffers per (shape, dtype), used in turn


class BatchStager:
    """Moves batch arrays (numpy or tensors, or lists of them) to
    ``device``; ``None`` stays ``None``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = None
        self._pinned: Dict[Tuple, List[list]] = {}
        self._turn: Dict[Tuple, int] = {}

    def __call__(self, a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [self(t) for t in a]
        if self.device.type != "cuda":
            return torch.as_tensor(a, device=self.device)
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.to(self.device)
        host = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return self._copy(host)

    def _buffer(self, host: torch.Tensor) -> list:
        key = (tuple(host.shape), host.dtype)
        ring = self._pinned.get(key)
        if ring is None:
            ring = self._pinned[key] = [
                [torch.empty(host.shape, dtype=host.dtype, pin_memory=True),
                 None] for _ in range(_DEPTH)]
        turn = self._turn.get(key, 0)
        self._turn[key] = turn + 1
        return ring[turn % _DEPTH]

    def _copy(self, host: torch.Tensor) -> torch.Tensor:
        slot = self._buffer(host)
        buf, last_copy = slot
        if last_copy is not None:
            last_copy.synchronize()
        buf.copy_(host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        user = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        slot[1] = done
        user.wait_event(done)
        dev.record_stream(user)
        return dev
