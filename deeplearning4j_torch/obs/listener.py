"""TelemetryListener — counterpart of ``deeplearning4j_tpu/obs/listener.py``:
bridges :class:`StepTelemetry` into a stats storage (the reference's
``ui/`` StatsStorage seam; duck-typed here, anything with
``put_static_info`` and ``put_update``).

Attach it to ``Trainer.fit(listeners=[...])``: the fit loop auto-adopts the
listener's ``.telemetry`` object (duck-typed — the trainer never imports
obs), so one argument both instruments the loop and periodically publishes
registry snapshots as storage updates the dashboard can chart alongside
score.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

from ..train.listeners import TrainingListener
from .step import StepTelemetry


class TelemetryListener(TrainingListener):
    """Publishes telemetry snapshots into a stats storage.

    ``storage=None`` keeps the listener purely as a telemetry carrier for
    fit auto-adoption (instrument the loop, publish nothing). Reporting is
    between-steps and host-side only; no sync flags, so the lagged
    deferred-readback reporting path stays intact.
    """

    def __init__(self, storage=None, telemetry: Optional[StepTelemetry] = None,
                 session_id: Optional[str] = None,
                 worker_id: str = "telemetry_0", frequency: int = 10):
        self.storage = storage
        self.telemetry = telemetry if telemetry is not None else StepTelemetry()
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.frequency = max(int(frequency), 1)
        self._initialized = False

    def _post_static(self, trainer):
        record = {
            "type": "telemetry",
            "metrics": sorted(self.telemetry.registry.snapshot()),
            "fence": self.telemetry.fence,
            "start_time": time.time(),
        }
        self.storage.put_static_info(self.session_id, "TelemetryListener",
                                     self.worker_id, record)
        self._initialized = True

    def iteration_done(self, trainer, iteration: int, epoch: int, loss: float):
        if self.storage is None:
            return
        if not self._initialized:
            self._post_static(trainer)
        if iteration % self.frequency != 0:
            return
        record = {
            "iteration": iteration,
            "epoch": epoch,
            "score": float(loss),
            "telemetry": self.telemetry.snapshot(),
            "metrics": self.telemetry.registry.snapshot(),
        }
        self.storage.put_update(self.session_id, "TelemetryListener",
                                self.worker_id, time.time(), record)

    def on_epoch_end(self, trainer, epoch: int):
        self.telemetry.tracer.instant("epoch_end", epoch=epoch)
