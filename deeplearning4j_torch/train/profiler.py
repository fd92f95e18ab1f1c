"""Profiling hooks — counterpart of ``deeplearning4j_tpu/train/profiler.py``.

:class:`ProfilerListener` captures a ``torch.profiler`` trace (CPU
activity, and CUDA activity where there is a card) for a chosen window of
training iterations and writes it as a Chrome/Perfetto trace under
``log_dir``; :class:`PhaseTimer` is the reference's phase-timing
collector, unchanged.

The window is ``[start_iteration, start_iteration + num_iterations)``.
The listener asks for in-order reporting (``requires_sync``), so the fit
loop reports iteration k right after dispatching it and the trace opens
and closes on iteration boundaries; each iteration inside the window
ends with a ``ProfilerListener.iteration_<k>`` marker in the trace. Before
the trace stops, the model's device is synchronized, so the window's
kernels are in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

from .listeners import TrainingListener


class ProfilerListener(TrainingListener):
    """Capture a torch.profiler trace for iterations [start, start+count)."""

    requires_sync = True  # open and close the window on iteration edges

    def __init__(self, log_dir: str, start_iteration: int = 5,
                 num_iterations: int = 3):
        self.log_dir = log_dir
        self.start = start_iteration
        self.end = start_iteration + num_iterations
        self._active = False
        self._prof = None
        self._device = None
        #: the trace files written, in order
        self.paths: List[str] = []

    @staticmethod
    def _mark(iteration: int) -> None:
        import torch

        with torch.profiler.record_function(
                f"ProfilerListener.iteration_{iteration}"):
            pass

    def _start(self, trainer) -> None:
        import torch

        self._device = getattr(trainer, "device", None)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._device is not None and self._device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self._device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._active = True

    def _stop(self) -> None:
        import torch

        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir,
                            f"trace_iterations_{self.start}_{self.end}.json")
        self._prof.export_chrome_trace(path)
        self.paths.append(path)
        self._prof = None
        self._active = False

    def on_epoch_start(self, trainer, epoch):
        # iteration_done fires only AFTER a step, so a window starting at
        # the current iteration (incl. 0) must open here
        if not self._active and trainer.iteration == self.start:
            self._start(trainer)

    def iteration_done(self, trainer, iteration, epoch, loss):
        if self._active:
            self._mark(iteration)
        if not self._active and iteration + 1 == self.start:
            self._start(trainer)
        elif self._active and iteration + 1 >= self.end:
            self._stop()

    def on_epoch_end(self, trainer, epoch):
        if self._active:  # the fit ended inside the window: close it
            self._stop()


class PhaseTimer:
    """Phase-timing collector — ParameterAveragingTrainingMasterStats parity:
    accumulate named phase durations, export a summary dict / JSON."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._spans: List[dict] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1
            self._spans.append({"name": name, "start": t0, "duration_s": dt})

    def summary(self) -> Dict[str, dict]:
        return {name: {"total_s": self._totals[name],
                       "count": self._counts[name],
                       "mean_s": self._totals[name] / max(self._counts[name], 1)}
                for name in self._totals}

    def export_json(self, path: Optional[str] = None) -> str:
        s = json.dumps({"summary": self.summary(), "spans": self._spans},
                       indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    def export_chrome_trace(self, path: str) -> None:
        """Chrome trace-event JSON (open in chrome://tracing / Perfetto)."""
        events = [{"name": s["name"], "ph": "X", "ts": s["start"] * 1e6,
                   "dur": s["duration_s"] * 1e6, "pid": 0, "tid": 0}
                  for s in self._spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
