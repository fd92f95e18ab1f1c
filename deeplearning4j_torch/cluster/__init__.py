"""cluster/ — replica-set serving that survives replica death; the port's
copy of ``deeplearning4j_tpu/cluster/`` (same names, answers and metrics).

The fleet layer made one process serve many models; this layer makes many
such processes serve as one endpoint. The division of labour:

- :mod:`.membership` — who is alive (heartbeat leases, injectable clock);
- :mod:`.placement`  — who should hold which model (bin-packing by
  weight bytes against per-replica HBM budgets);
- :mod:`.router`     — the one front door: failover, gold-class hedging,
  a global retry budget, and cluster-wide tenant quotas;
- :mod:`.replica`    — in-process replica spawning for drills and tests.

Stdlib only on the cluster side; everything device-shaped stays inside
the replicas' own fleet registries.
"""

from .membership import ALIVE, DEAD, SUSPECT, Membership, ReplicaInfo
from .placement import Placement
from .replica import ReplicaHandle, spawn_replica
from .router import (PRE_ADMISSION_CAUSES, ClusterRouter, NoReplicaError,
                     RetryBudget)

__all__ = [
    "ALIVE", "SUSPECT", "DEAD", "Membership", "ReplicaInfo",
    "Placement",
    "ClusterRouter", "RetryBudget", "NoReplicaError",
    "PRE_ADMISSION_CAUSES",
    "ReplicaHandle", "spawn_replica",
]
