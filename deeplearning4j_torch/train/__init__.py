"""Training-side modules of the port: the trainer, its listeners, early
stopping, the line-search solvers, divergence rollback and segmented
checkpoint-resume (``faults``, from ``chaos/recovery``), the profiler
window listener and phase timer, model serialization (params, state,
updater state and the data normalizer) and the sharded trainer
checkpoint (``orbax_io``)."""

from .earlystopping import (EarlyStoppingConfiguration,
                            EarlyStoppingParallelTrainer, EarlyStoppingResult,
                            EarlyStoppingTrainer)
from .faults import (DivergenceListener, FaultTolerantFit,
                     TrainingDivergedException)
from .listeners import (CheckpointListener, CollectScoresListener,
                        DeferredScoreReporter, EvaluativeListener,
                        PerformanceListener, ScoreIterationListener,
                        SleepyTrainingListener, TimeIterationListener,
                        TrainingListener)
from .profiler import PhaseTimer, ProfilerListener
from .orbax_io import (load_model_json, restore_checkpoint, restore_trainer,
                       save_checkpoint, save_trainer)
from .serialization import (load_model, load_normalizer, load_opt_state,
                            model_from_json, opt_state_from_numpy,
                            params_from_numpy, save_model, state_from_numpy)
from .trainer import (Trainer, build_updater, evaluate_model,
                      model_output_width, score_model)

__all__ = ["CheckpointListener", "CollectScoresListener",
           "DeferredScoreReporter", "DivergenceListener",
           "EarlyStoppingConfiguration", "EarlyStoppingParallelTrainer",
           "EarlyStoppingResult", "EarlyStoppingTrainer",
           "EvaluativeListener", "FaultTolerantFit", "PerformanceListener",
           "PhaseTimer", "ProfilerListener",
           "ScoreIterationListener", "SleepyTrainingListener",
           "TimeIterationListener", "Trainer", "TrainingDivergedException",
           "TrainingListener",
           "build_updater", "evaluate_model", "load_model",
           "load_model_json", "load_normalizer", "load_opt_state",
           "model_from_json", "model_output_width",
           "opt_state_from_numpy", "params_from_numpy", "restore_checkpoint",
           "restore_trainer", "save_checkpoint", "save_model", "save_trainer",
           "score_model", "state_from_numpy"]
