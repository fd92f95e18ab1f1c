"""sim/ — deterministic trace-replay simulation + serving-config autotuning;
the port's copy of ``deeplearning4j_tpu/sim/`` (byte-equal traces,
reports and tuner winners).

The scenario generator behind the "millions of users" claim: seeded
open-loop workload synthesis (``workload``), replay against either a
bit-deterministic discrete-event model of the serving stack or a live
in-process fleet (``replay``), deterministic scoring from the same
signals the obs stack exports (``score``), and a successive-halving
autotuner that persists winning knob sets into the AOT store keyed by
(runtime fingerprint, workload fingerprint) (``tune``).

Layering: sim/ sits ABOVE serve/, fleet/ and cluster/ — nothing below it
imports it. The store-side half of tuned-config resolution lives in
``aot/tuned.py`` so engines can resolve configs at boot without a sim
import.
"""

from .replay import (CostModel, DEFAULT_KNOBS, FleetTarget, LiveReplayer,
                     RouterTarget, VirtualReplayer, flatten_knobs,
                     merge_knobs, set_flat)
from .score import Outcome, REPORT_SCHEMA, TYPED_CAUSES, report_json, score, \
    summarize
from .tune import DEFAULT_SPACE, TuneResult, Tuner, record_winner
from .workload import (CLASS_DEADLINES_MS, Event, LengthDist, Trace,
                       WorkloadSpec, generate_trace, prompt_tokens,
                       smoke_spec)

__all__ = [
    "CLASS_DEADLINES_MS", "CostModel", "DEFAULT_KNOBS", "DEFAULT_SPACE",
    "Event", "FleetTarget", "LengthDist", "LiveReplayer", "Outcome",
    "REPORT_SCHEMA", "RouterTarget", "TYPED_CAUSES", "Trace", "TuneResult",
    "Tuner", "VirtualReplayer", "WorkloadSpec", "flatten_knobs",
    "generate_trace",
    "merge_knobs", "prompt_tokens", "record_winner", "report_json", "score",
    "set_flat", "smoke_spec", "summarize",
]
