"""Training-side modules of the port: the trainer, its listeners, early
stopping, the line-search solvers, divergence rollback and segmented
checkpoint-resume (``faults``, from ``chaos/recovery``), the profiler
window listener and phase timer, and model serialization (params, state,
updater state and the data normalizer)."""

from .earlystopping import (EarlyStoppingConfiguration, EarlyStoppingResult,
                            EarlyStoppingTrainer)
from .faults import (DivergenceListener, FaultTolerantFit,
                     TrainingDivergedException)
from .listeners import (CheckpointListener, CollectScoresListener,
                        DeferredScoreReporter, EvaluativeListener,
                        PerformanceListener, ScoreIterationListener,
                        SleepyTrainingListener, TimeIterationListener,
                        TrainingListener)
from .profiler import PhaseTimer, ProfilerListener
from .serialization import (load_model, load_normalizer, load_opt_state,
                            model_from_json, opt_state_from_numpy,
                            params_from_numpy, save_model, state_from_numpy)
from .trainer import (Trainer, build_updater, evaluate_model,
                      model_output_width, score_model)

__all__ = ["CheckpointListener", "CollectScoresListener",
           "DeferredScoreReporter", "DivergenceListener",
           "EarlyStoppingConfiguration",
           "EarlyStoppingResult", "EarlyStoppingTrainer",
           "EvaluativeListener", "FaultTolerantFit", "PerformanceListener",
           "PhaseTimer", "ProfilerListener",
           "ScoreIterationListener", "SleepyTrainingListener",
           "TimeIterationListener", "Trainer", "TrainingDivergedException",
           "TrainingListener",
           "build_updater", "evaluate_model", "load_model",
           "load_normalizer", "load_opt_state", "model_from_json",
           "model_output_width",
           "opt_state_from_numpy", "params_from_numpy", "save_model",
           "score_model", "state_from_numpy"]
