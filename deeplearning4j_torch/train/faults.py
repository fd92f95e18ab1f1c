"""Import shim — the training fault/recovery tools moved into the chaos
fault plane (``chaos/recovery.py``), next to the injector that exercises
them, so there is exactly ONE fault-injection path in the tree. This
module keeps the historical ``train.faults`` import path working.
"""

from ..chaos.recovery import (DivergenceListener, FaultTolerantFit,
                              TrainingDivergedException)

__all__ = ["DivergenceListener", "FaultTolerantFit",
           "TrainingDivergedException"]
