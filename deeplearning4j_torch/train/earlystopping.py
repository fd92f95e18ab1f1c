"""Early stopping — counterpart of ``deeplearning4j_tpu/train/earlystopping.py``:
``EarlyStoppingConfiguration``, the termination conditions (MaxEpochs,
ScoreImprovementEpoch, BestScoreEpoch; MaxTime, MaxScore and InvalidScore
by iteration), the score calculators (held-out loss, classification error,
ROC AUC, a regression metric, the VAE's reconstruction error and
probability, the AutoEncoder's reconstruction loss), the in-memory and
local-file model savers, and ``EarlyStoppingTrainer`` driving a
``Trainer`` one epoch at a time.

As in the reference, an iteration condition that fires lets the epoch run
to its end and then stops training. The guard that reads every step's
loss is a ``requires_sync`` listener when there are iteration conditions,
so each loss is read in order under the port's deferred score reporting
(and ``steps_per_execution`` windows are off for it). The VAE's scores
draw their noise from a ``torch.Generator`` seeded with ``seed``: the same
seed gives the same score run to run, but not the reference's (the
packages draw different random streams).

``EarlyStoppingParallelTrainer`` waits for ``parallel/`` (ROADMAP.md,
Queue 1: item 14).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.updaters import tree_leaves, tree_unflatten
from .listeners import TrainingListener


# --- termination conditions ---

class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, loss: float) -> bool:
        raise NotImplementedError


@dataclass
class MaxEpochsTermination(EpochTerminationCondition):
    max_epochs: int

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs - 1


@dataclass
class ScoreImprovementEpochTermination(EpochTerminationCondition):
    """Stop after more than N epochs without an improvement of at least
    ``min_improvement``."""

    max_epochs_without_improvement: int
    min_improvement: float = 0.0
    _best: float = field(default=np.inf, repr=False)
    _since: int = field(default=0, repr=False)

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._since = 0
        else:
            self._since += 1
        return self._since > self.max_epochs_without_improvement


@dataclass
class BestScoreEpochTermination(EpochTerminationCondition):
    """Stop once the score is below ``target_score``."""

    target_score: float

    def terminate(self, epoch, score):
        return score < self.target_score


@dataclass
class MaxTimeIterationTermination(IterationTerminationCondition):
    max_seconds: float
    _start: Optional[float] = field(default=None, repr=False)

    def terminate(self, loss):
        if self._start is None:
            self._start = time.monotonic()
        return (time.monotonic() - self._start) > self.max_seconds


@dataclass
class MaxScoreIterationTermination(IterationTerminationCondition):
    """Stop a run whose loss exceeds ``max_score``."""

    max_score: float

    def terminate(self, loss):
        return loss > self.max_score


@dataclass
class InvalidScoreIterationTermination(IterationTerminationCondition):
    """InvalidScoreIterationTerminationCondition — a NaN or infinite
    loss."""

    def terminate(self, loss):
        return not np.isfinite(loss)


# --- score calculators ---

class ScoreCalculator:
    def score(self, trainer) -> float:
        raise NotImplementedError


@dataclass
class DataSetLossCalculator(ScoreCalculator):
    """The average loss on a held-out iterator."""

    iterator: Any

    def score(self, trainer):
        return trainer.score_iterator(self.iterator)


@dataclass
class ClassificationScoreCalculator(ScoreCalculator):
    """1 - accuracy on a held-out iterator."""

    iterator: Any

    def score(self, trainer):
        return 1.0 - trainer.evaluate(self.iterator).accuracy()


@dataclass
class ROCScoreCalculator(ScoreCalculator):
    """1 - the average one-vs-rest AUC on a held-out iterator."""

    iterator: Any
    num_classes: int = 2

    def score(self, trainer):
        from ..eval import ROCMultiClass

        roc = ROCMultiClass(self.num_classes)
        for ds in self.iterator:
            preds = trainer.model.output(ds.features, trainer.params,
                                         trainer.state)
            if isinstance(preds, list):
                preds = preds[0]
            roc.eval(ds.labels, preds)
        _maybe_reset(self.iterator)
        return 1.0 - roc.average_auc()


@dataclass
class RegressionScoreCalculator(ScoreCalculator):
    """A ``RegressionEvaluation`` metric averaged over the columns (mse,
    mae, rmse, r2 or pearson; r2 and pearson negated, so lower is
    better)."""

    iterator: Any
    metric: str = "mse"

    _HIGHER_IS_BETTER = {"r2", "pearson"}

    def score(self, trainer):
        from ..eval import RegressionEvaluation
        from .trainer import model_output_width

        ev = trainer.evaluate(self.iterator, evaluation=RegressionEvaluation(
            model_output_width(trainer.model)))
        val = float(np.mean([getattr(ev, self.metric)(i)
                             for i in range(ev.n)]))
        return -val if self.metric in self._HIGHER_IS_BETTER else val


def _find_layer(trainer, cls_name):
    """(layer, params key, index) of the first layer of a Sequential
    whose class is ``cls_name``."""
    from ..nn.model import _layer_key

    for i, layer in enumerate(trainer.model.layers):
        if type(layer).__name__ == cls_name:
            return layer, _layer_key(i, layer), i
    raise ValueError(f"model has no {cls_name} layer")


def _features_up_to(trainer, ds, layer_index):
    """The inference activations feeding layer ``layer_index``."""
    x = trainer._stage(ds.features)
    if layer_index == 0:
        return x
    with torch.no_grad():
        return trainer.model.forward(trainer.params, trainer.state, x,
                                     training=False, up_to=layer_index)[0]


def _layer_score(trainer, iterator, cls_name, fn) -> float:
    """The mean over ``iterator``'s batches of ``fn(layer, params,
    feats)``."""
    layer, key, idx = _find_layer(trainer, cls_name)
    total, n = 0.0, 0
    with torch.no_grad():
        for ds in iterator:
            feats = _features_up_to(trainer, ds, idx)
            total += float(fn(layer, trainer.params[key], feats))
            n += 1
    _maybe_reset(iterator)
    return total / max(n, 1)


def _seeded(trainer, seed):
    return torch.Generator(device=trainer.device).manual_seed(seed)


@dataclass
class VAEReconErrorScoreCalculator(ScoreCalculator):
    """The VAE's pretraining loss (its negative ELBO) on a held-out
    iterator, with noise from a generator seeded with ``seed`` for each
    scoring pass."""

    iterator: Any
    seed: int = 0

    def score(self, trainer):
        gen = _seeded(trainer, self.seed)
        return _layer_score(trainer, self.iterator, "VAE",
                            lambda l, p, f: l.pretrain_loss(p, f, gen))


@dataclass
class VAEReconProbScoreCalculator(ScoreCalculator):
    """The negated mean importance-sampled reconstruction log-probability
    on a held-out iterator (higher probability is better)."""

    iterator: Any
    num_samples: int = 16
    seed: int = 0

    def score(self, trainer):
        gen = _seeded(trainer, self.seed)
        return -_layer_score(
            trainer, self.iterator, "VAE",
            lambda l, p, f: torch.mean(l.reconstruction_log_probability(
                p, f, gen, num_samples=self.num_samples)))


@dataclass
class AutoencoderScoreCalculator(ScoreCalculator):
    """The AutoEncoder's reconstruction loss (no corruption) on a held-out
    iterator."""

    iterator: Any

    def score(self, trainer):
        return _layer_score(trainer, self.iterator, "AutoEncoder",
                            lambda l, p, f: l.pretrain_loss(p, f))


def _maybe_reset(it):
    if hasattr(it, "reset"):
        it.reset()


# --- model savers ---

class ModelSaver:
    def save_best(self, trainer, score: float):
        raise NotImplementedError

    def get_best(self):
        raise NotImplementedError


def _snapshot(tree):
    """A copy of a tree of tensors: the trainer updates its own in
    place."""
    return tree_unflatten(tree, [t.detach().clone() for t in tree_leaves(tree)])


class InMemoryModelSaver(ModelSaver):
    """The best (params, state, score), copied at the time it was best."""

    def __init__(self):
        self.best = None

    def save_best(self, trainer, score):
        self.best = (_snapshot(trainer.params), _snapshot(trainer.state),
                     score)

    def get_best(self):
        return self.best


@dataclass
class LocalFileModelSaver(ModelSaver):
    """The best model as ``bestModel.zip`` (with its updater state) in
    ``directory``; ``get_best`` loads it onto the device it was trained
    on."""

    directory: str
    _device: Any = field(default=None, repr=False)

    def save_best(self, trainer, score):
        os.makedirs(self.directory, exist_ok=True)
        self._device = trainer.device
        trainer.save(os.path.join(self.directory, "bestModel.zip"))

    def get_best(self):
        from .serialization import load_model

        return load_model(os.path.join(self.directory, "bestModel.zip"),
                          device=self._device)


# --- configuration and trainer ---

@dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator
    epoch_terminations: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_terminations: List[IterationTerminationCondition] = field(
        default_factory=list)
    model_saver: ModelSaver = field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    best_epoch: int
    best_score: float
    total_epochs: int
    score_vs_epoch: Dict[int, float]


class _IterationGuard(TrainingListener):
    """Reads every step's loss against the iteration conditions and
    records the first that fires."""

    def __init__(self, conditions):
        self.conditions = conditions
        self.requires_sync = bool(conditions)
        self.fired = None

    def iteration_done(self, trainer, iteration, epoch, loss):
        for cond in self.conditions:
            if cond.terminate(loss):
                self.fired = f"{type(cond).__name__} at loss {loss:.4g}"


class EarlyStoppingTrainer:
    """earlystopping/trainer/EarlyStoppingTrainer.java: one epoch of
    ``trainer.fit`` at a time, scored every ``evaluate_every_n_epochs``;
    the best score's model goes to the saver; the epoch conditions are
    checked after each scoring."""

    def __init__(self, config: EarlyStoppingConfiguration, trainer):
        self.config = config
        self.trainer = trainer

    def fit(self, train_iterator, max_epochs: int = 10_000,
            listeners=()) -> EarlyStoppingResult:
        cfg = self.config
        best_score, best_epoch = np.inf, -1
        scores: Dict[int, float] = {}
        reason, details = "MaxEpochs", f"reached {max_epochs}"
        guard = _IterationGuard(cfg.iteration_terminations)
        epoch = 0
        for epoch in range(max_epochs):
            self.trainer.fit(train_iterator, epochs=1,
                             listeners=[guard, *listeners])
            if guard.fired is not None:
                reason, details = "IterationTermination", guard.fired
                break
            if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                s = cfg.score_calculator.score(self.trainer)
                scores[epoch] = s
                if s < best_score:
                    best_score, best_epoch = s, epoch
                    cfg.model_saver.save_best(self.trainer, s)
                fired = next((c for c in cfg.epoch_terminations
                              if c.terminate(epoch, s)), None)
                if fired is not None:
                    reason, details = "EpochTermination", type(fired).__name__
                    break
        return EarlyStoppingResult(reason, details, best_epoch,
                                   float(best_score), epoch + 1, scores)
