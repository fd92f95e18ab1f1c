"""ParallelInference — counterpart of
``deeplearning4j_tpu/parallel/inference.py``: the reference's batched
inference server (``InferenceMode.BATCHED``) as a thin surface over the
port's :class:`~deeplearning4j_torch.serve.engine.ServeEngine` and
:class:`~deeplearning4j_torch.serve.registry.ModelRegistry`.

Concurrent ``output`` calls coalesce into the smallest batch bucket that
fits (buckets above ``batch_limit`` dropped); a request larger than the
largest bucket splits across bucket-sized sub-batches. ``output`` blocks,
and a full queue blocks the caller (``admission="block"``) instead of
shedding. ``update_model`` is a registry publish: the new params swapped
in atomically, after the in-flight batches on the old ones finish.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..serve.engine import ServeEngine
from ..serve.registry import ModelRegistry


class ParallelInference:
    """Batched inference server (InferenceMode.BATCHED parity) on the
    model's device."""

    def __init__(self, model, params=None, state=None, batch_limit: int = 32,
                 queue_limit: int = 64, max_wait_ms: float = 2.0,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32)):
        self.model = model
        params = params if params is not None else model.params
        state = state if state is not None else model.state
        if params is None:
            raise ValueError("model must be initialized")
        self.batch_limit = batch_limit
        self.max_wait_ms = max_wait_ms
        self.buckets = sorted(b for b in buckets if b <= batch_limit) \
            or [batch_limit]
        self.registry = ModelRegistry(params, state)
        self.engine = ServeEngine(model, registry=self.registry,
                                  batch_buckets=self.buckets,
                                  queue_limit=queue_limit,
                                  max_wait_ms=max_wait_ms,
                                  admission="block")

    @property
    def params(self):
        return self.registry.current().params

    @property
    def state(self):
        return self.registry.current().state

    def output(self, x) -> np.ndarray:
        """Blocking single-request API (ParallelInference.output)."""
        return self.engine.predict(x)

    def update_model(self, params, state=None):
        """Hot-swap weights (ParallelInference.updateModel): an atomic
        registry publish that waits for in-flight batches on the old
        generation."""
        self.registry.publish(params, state=state, drain=True)

    def shutdown(self):
        self.engine.shutdown(drain=True)
