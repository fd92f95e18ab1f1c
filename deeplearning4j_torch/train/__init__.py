"""Training-side modules of the port: the trainer, its listeners and model
serialization (params, state and updater state)."""

from .listeners import (CollectScoresListener, DeferredScoreReporter,
                        PerformanceListener, ScoreIterationListener,
                        TrainingListener)
from .serialization import (load_model, load_opt_state, model_from_json,
                            opt_state_from_numpy, params_from_numpy,
                            save_model, state_from_numpy)
from .trainer import Trainer, build_updater

__all__ = ["CollectScoresListener", "DeferredScoreReporter",
           "PerformanceListener", "ScoreIterationListener", "Trainer",
           "TrainingListener", "build_updater", "load_model",
           "load_opt_state", "model_from_json", "opt_state_from_numpy",
           "params_from_numpy", "save_model", "state_from_numpy"]
