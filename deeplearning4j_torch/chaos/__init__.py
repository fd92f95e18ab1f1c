"""chaos/ — deterministic fault injection and shared resilience primitives;
the port's copy of ``deeplearning4j_tpu/chaos/`` (its training-side
``recovery`` module loads the trainer only when used).

Stdlib-only base layer: the seeded :class:`FaultPlane` with its named
injection points, and the :class:`RetryPolicy` that serve/ and fleet/ wrap
around their fallible I/O. Off by default.
"""

# NOTE: faults.ACTIVE is deliberately NOT re-exported — a `from` import
# would freeze the value at import time. Injection sites read it as a
# module attribute: `from ..chaos import faults` ... `faults.ACTIVE`.
from .faults import (POINTS, FaultPlane, install, parse_spec, scenario,
                     uninstall)
from .retry import RetryPolicy

__all__ = [
    "POINTS",
    "FaultPlane",
    "RetryPolicy",
    "install",
    "parse_spec",
    "scenario",
    "uninstall",
]
