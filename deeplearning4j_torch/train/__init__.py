"""Training-side modules of the port: the trainer, its listeners, early
stopping, the line-search solvers and model serialization (params, state,
updater state and the data normalizer)."""

from .earlystopping import (EarlyStoppingConfiguration, EarlyStoppingResult,
                            EarlyStoppingTrainer)
from .listeners import (CheckpointListener, CollectScoresListener,
                        DeferredScoreReporter, EvaluativeListener,
                        PerformanceListener, ScoreIterationListener,
                        SleepyTrainingListener, TimeIterationListener,
                        TrainingListener)
from .serialization import (load_model, load_normalizer, load_opt_state,
                            model_from_json, opt_state_from_numpy,
                            params_from_numpy, save_model, state_from_numpy)
from .trainer import Trainer, build_updater, evaluate_model, score_model

__all__ = ["CheckpointListener", "CollectScoresListener",
           "DeferredScoreReporter", "EarlyStoppingConfiguration",
           "EarlyStoppingResult", "EarlyStoppingTrainer",
           "EvaluativeListener", "PerformanceListener",
           "ScoreIterationListener", "SleepyTrainingListener",
           "TimeIterationListener", "Trainer", "TrainingListener",
           "build_updater", "evaluate_model", "load_model",
           "load_normalizer", "load_opt_state", "model_from_json",
           "opt_state_from_numpy", "params_from_numpy", "save_model",
           "score_model", "state_from_numpy"]
