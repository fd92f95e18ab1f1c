"""Training listeners — counterpart of
``deeplearning4j_tpu/train/listeners.py`` (TrainingListener,
DeferredScoreReporter, ScoreIterationListener, CollectScoresListener,
PerformanceListener, EvaluativeListener, TimeIterationListener,
SleepyTrainingListener, CheckpointListener).

Listeners observe between steps (``iteration_done``) and at epoch edges.
The loss of step k is a tensor on the card; :class:`DeferredScoreReporter`
reads it back only after step k+1 has been dispatched, so the host's
``.item()`` never leaves the card idle between steps. Under
``steps_per_execution`` a window of K steps is reported the same way,
its K losses read back together after the next dispatch.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

logger = logging.getLogger("deeplearning4j_torch")


class TrainingListener:
    """Hook contract (TrainingListener.java).

    ``requires_sync``: set True on listeners that steer the training loop
    from ``iteration_done``; they force in-order reporting, so their
    decision acts before the next step is dispatched. ``snapshots_state``:
    set True on listeners that read trainer params in ``iteration_done``;
    they too force in-order reporting, so iteration i sees iteration i's
    params."""

    requires_sync: bool = False
    snapshots_state: bool = False

    def on_epoch_start(self, trainer, epoch: int):
        pass

    def on_epoch_end(self, trainer, epoch: int):
        pass

    def iteration_done(self, trainer, iteration: int, epoch: int, loss: float):
        pass


class DeferredScoreReporter:
    """The fit loop's loss-reporting pipeline: holds the device scalar of
    the previous iteration and reads it back only after the next step has
    been dispatched. Synchronous when any listener ``requires_sync`` or
    ``snapshots_state``. Every iteration is reported exactly once, in
    order."""

    def __init__(self, trainer, listeners, reduce=float):
        self.trainer = trainer
        self.listeners = list(listeners)
        self.reduce = reduce  # device scalar -> float
        self.lagged = not any(getattr(l, "requires_sync", False)
                              or getattr(l, "snapshots_state", False)
                              for l in self.listeners)
        self._pending = None

    def flush(self):
        if self._pending is None:
            return
        it_idx, epoch, loss_dev, window = self._pending
        self._pending = None
        # a window's (K,) losses come back in one read
        losses = loss_dev.tolist() if window else [self.reduce(loss_dev)]
        for i, lossf in enumerate(losses):
            for lst in self.listeners:
                lst.iteration_done(self.trainer, it_idx + i, epoch, lossf)

    def _hold(self, pending):
        if self.lagged:
            self.flush()  # the PREVIOUS dispatch, while this one runs
            self._pending = pending
        else:
            self._pending = pending
            self.flush()

    def report(self, iteration: int, epoch: int, loss_dev):
        """Call right after dispatching ``iteration``'s step."""
        self._hold((iteration, epoch, loss_dev, False))

    def report_window(self, first_iteration: int, epoch: int, losses_dev):
        """Call right after dispatching a window of K steps whose (K,)
        device losses are ``losses_dev`` (iterations ``first_iteration``
        to ``first_iteration + K - 1``): each is reported in order, all
        read back at once."""
        self._hold((first_iteration, epoch, losses_dev, True))


class ScoreIterationListener(TrainingListener):
    """ScoreIterationListener.java — log the loss every N iterations."""

    def __init__(self, print_every: int = 10,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.print_every = print_every
        self.log = log_fn or (lambda s: logger.info(s))

    def iteration_done(self, trainer, iteration, epoch, loss):
        if iteration % self.print_every == 0:
            self.log(f"iter {iteration} epoch {epoch} score {loss:.6f}")


class CollectScoresListener(TrainingListener):
    """CollectScoresIterationListener.java — record (iteration, score) pairs."""

    def __init__(self, frequency: int = 1):
        self.frequency = frequency
        self.scores: List[tuple] = []

    def iteration_done(self, trainer, iteration, epoch, loss):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, loss))


class PerformanceListener(TrainingListener):
    """PerformanceListener.java — samples/sec, batches/sec and ETL time
    (the host gap between one step's end and the next step's start), over
    windows of ``frequency`` iterations. With deferred reporting the
    window ends when iteration k's loss is read, one step late."""

    def __init__(self, frequency: int = 10, log_fn=None):
        self.frequency = frequency
        self.log = log_fn or (lambda s: logger.info(s))
        self._last_end: Optional[float] = None
        self.samples_per_sec: float = 0.0
        self.batches_per_sec: float = 0.0
        self.last_etl_ms: float = 0.0
        self._window_start = None
        self._window_iters = 0
        self._window_samples = 0

    def step_begin(self, batch_size: int):
        now = time.perf_counter()
        if self._last_end is not None:
            self.last_etl_ms = (now - self._last_end) * 1e3
        if self._window_start is None:
            self._window_start = now
        self._window_samples += batch_size

    def iteration_done(self, trainer, iteration, epoch, loss):
        now = time.perf_counter()
        self._last_end = now
        self._window_iters += 1
        if self._window_iters >= self.frequency:
            dt = now - self._window_start
            self.batches_per_sec = self._window_iters / dt
            self.samples_per_sec = self._window_samples / dt
            self.log(f"iter {iteration}: {self.samples_per_sec:.1f} samples/sec, "
                     f"{self.batches_per_sec:.2f} batches/sec, "
                     f"ETL {self.last_etl_ms:.2f} ms")
            self._window_start, self._window_iters, self._window_samples = now, 0, 0


class EvaluativeListener(TrainingListener):
    """EvaluativeListener.java — evaluate on ``test_iterator`` every
    ``frequency`` epochs (``invocation="epoch_end"``) or iterations
    (``"iteration"``; it then reads the params in ``iteration_done``, so
    it ``snapshots_state``)."""

    def __init__(self, test_iterator, frequency: int = 1,
                 invocation: str = "epoch_end", evaluation_factory=None,
                 log_fn=None):
        self.test_iterator = test_iterator
        self.frequency = frequency
        self.invocation = invocation
        self.snapshots_state = invocation == "iteration"
        self.evaluation_factory = evaluation_factory
        self.log = log_fn or (lambda s: logger.info(s))
        self.last_evaluation = None

    def _run(self, trainer):
        ev = trainer.evaluate(
            self.test_iterator,
            evaluation=(self.evaluation_factory()
                        if self.evaluation_factory else None))
        self.last_evaluation = ev
        self.log(f"eval accuracy={ev.accuracy():.4f} f1={ev.f1():.4f}")

    def on_epoch_end(self, trainer, epoch):
        if self.invocation == "epoch_end" and (epoch + 1) % self.frequency == 0:
            self._run(trainer)

    def iteration_done(self, trainer, iteration, epoch, loss):
        if self.invocation == "iteration" and iteration > 0 \
                and iteration % self.frequency == 0:
            self._run(trainer)


class TimeIterationListener(TrainingListener):
    """TimeIterationListener.java — log the estimated time left every
    ``frequency`` iterations."""

    def __init__(self, total_iterations: int, frequency: int = 100,
                 log_fn=None):
        self.total = total_iterations
        self.frequency = frequency
        self.log = log_fn or (lambda s: logger.info(s))
        self.start = time.perf_counter()

    def iteration_done(self, trainer, iteration, epoch, loss):
        if iteration and iteration % self.frequency == 0:
            rate = iteration / (time.perf_counter() - self.start)
            remaining = (self.total - iteration) / max(rate, 1e-9)
            self.log(f"iter {iteration}/{self.total} ETA {remaining:.0f}s")


class SleepyTrainingListener(TrainingListener):
    """SleepyTrainingListener.java — sleep ``sleep_ms`` after every
    iteration."""

    def __init__(self, sleep_ms: float = 0.0):
        self.sleep_ms = sleep_ms

    def iteration_done(self, trainer, iteration, epoch, loss):
        if self.sleep_ms > 0:
            time.sleep(self.sleep_ms / 1e3)


class CheckpointListener(TrainingListener):
    """CheckpointListener.java — a model zip (with the updater state
    unless ``save_updater=False``) every N iterations and/or epochs as
    ``checkpoint_iter<i>.zip`` / ``checkpoint_epoch<e>.zip``, keeping the
    last ``keep_last``. Per-iteration checkpoints read the params in
    ``iteration_done``, so such an instance ``snapshots_state``."""

    def __init__(self, directory: str, every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = None,
                 keep_last: Optional[int] = None, save_updater: bool = True):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.snapshots_state = every_n_iterations is not None
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = keep_last
        self.save_updater = save_updater
        self.saved: List[str] = []

    def _save(self, trainer, tag: str):
        from .serialization import save_model

        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        save_model(path, trainer.model, params=trainer.params,
                   state=trainer.state,
                   opt_state=trainer.opt_state if self.save_updater else None)
        self.saved.append(path)
        if self.keep_last and len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iteration_done(self, trainer, iteration, epoch, loss):
        if self.every_n_iterations and iteration > 0 \
                and iteration % self.every_n_iterations == 0:
            self._save(trainer, f"iter{iteration}")

    def on_epoch_end(self, trainer, epoch):
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._save(trainer, f"epoch{epoch + 1}")
