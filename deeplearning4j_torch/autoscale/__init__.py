"""autoscale/ — SLO-burn-driven elastic replica autoscaling; the port's
copy of ``deeplearning4j_tpu/autoscale/`` (byte-equal decision logs).

The control loop that turns the observability the stack already emits
into fleet-size decisions: :mod:`.signals` samples burn / queue depth /
KV pressure on one injectable clock, :mod:`.policy` turns the window
into a typed :class:`~.policy.ScaleDecision` (sustain windows, separate
out/in cooldowns, hysteresis, min/max clamps), and :mod:`.controller`
actuates through ``cluster/``: spawn → AOT-warm → first beat on the way
out, drain-then-retire on the way in. Deterministic end to end — same
trace + seed + fake clock ⇒ byte-identical decision log.
"""

from .controller import AutoscaleController
from .policy import (DEFAULT_BURN_OUT, HOLD, IN, OUT, AutoscalePolicy,
                     ScaleDecision)
from .signals import Sample, SignalReader, StepTimeSignalReader

__all__ = [
    "AutoscaleController",
    "AutoscalePolicy",
    "DEFAULT_BURN_OUT",
    "HOLD",
    "IN",
    "OUT",
    "Sample",
    "ScaleDecision",
    "SignalReader",
    "StepTimeSignalReader",
]
