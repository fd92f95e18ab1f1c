"""elastic/ — counterpart of ``deeplearning4j_tpu/elastic``: fault-tolerant
elastic training on the serving control plane.

:class:`ElasticTrainer` runs a ZeRO-1 data-parallel step (arXiv
2004.13336) under membership supervision, resizes its ladder of widths on
a chaos-injected worker death or an autoscale step-time-burn decision,
redistributes the updater state by the planner's blocks (arXiv
2112.01075), and publishes an atomic checkpoint at every resize
boundary (``train/orbax_io`` underneath).
"""

from .checkpoint import CheckpointInfo, latest, save_atomic
from .reshard import (LeafLayout, LeafMove, ReshardPlan, leaf_layout,
                      plan_leaf, plan_reshard)
from .trainer import (ElasticError, ElasticTrainer, NoCheckpointError,
                      QuorumLostError)

__all__ = [
    "CheckpointInfo",
    "ElasticError",
    "ElasticTrainer",
    "LeafLayout",
    "LeafMove",
    "NoCheckpointError",
    "QuorumLostError",
    "ReshardPlan",
    "latest",
    "leaf_layout",
    "plan_leaf",
    "plan_reshard",
    "save_atomic",
]
