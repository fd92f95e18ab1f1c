"""Autoscale input signals — burn, queue depth, KV pressure on one clock;
the port's copy of ``deeplearning4j_tpu/autoscale/signals.py``.

The autoscaler decides from exactly three observables the stack already
exports, sampled together so they can never disagree about *when* they
were true:

- **burn rate** per (model, slo_class) from :class:`~..obs.slo.SloBurn`
  (the router's model-keyed tracker — the number an SLO dashboard alerts
  on, and therefore the number scaling must answer to);
- **queue depth** from each replica's membership self-report (the beat
  payload's ``queue_depth`` — work admitted but not yet served);
- **KV-block pressure** from the same self-report (``kv_utilization`` —
  the memory half of saturation; a fleet can be latency-fine and one
  burst away from ``queue_full`` sheds).

Every timestamp comes from the injected ``clock``. This module NEVER
reads wall time — the same discipline as membership leases and the burn
wheel — so a fake clock makes the whole control loop bit-reproducible:
same signal history + same clock ⇒ the same :class:`Sample` window ⇒
the same policy decision, in tests, in sim replays, across processes.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, NamedTuple

from ..cluster.membership import DEAD


class Sample(NamedTuple):
    """One observation of fleet load, taken at ``t`` on the injected clock.

    ``burn`` folds the per-model detail to the worst burn per SLO class —
    the class's budget is spent by its worst model, and scaling adds
    capacity fleet-wide. ``burn_detail`` keeps the per-(model, class)
    numbers as decision evidence.
    """

    t: float
    burn: Dict[str, float]          # slo_class -> worst burn across models
    burn_detail: Dict[str, float]   # "model/slo_class" -> burn (evidence)
    queue_depth: int                # summed replica self-reported depth
    kv_pressure: float              # worst replica KV-block utilization
    alive: int                      # non-dead replicas in membership


class _SampleWindow:
    """The rolling window + sustain predicate every signal reader shares.

    Subclasses produce :class:`Sample`\\ s however they like (fleet scrape,
    training step times) and push them through :meth:`_push`; the policy
    only ever consumes :meth:`window` / :meth:`sustained`, so one reader
    is substitutable for another by construction."""

    def __init__(self, window_s: float):
        if window_s <= 0:
            raise ValueError("need window_s > 0")
        self.window_s = float(window_s)
        self._samples: Deque[Sample] = deque()

    def _push(self, s: Sample) -> Sample:
        """Append one sample and age out everything past the window."""
        self._samples.append(s)
        horizon = s.t - self.window_s
        while self._samples and self._samples[0].t < horizon:
            self._samples.popleft()
        return s

    def window(self) -> List[Sample]:
        """The retained samples, oldest first."""
        return list(self._samples)

    def sustained(self, pred: Callable[[Sample], bool], for_s: float,
                  now: float) -> bool:
        """True iff the window reaches back at least ``for_s`` seconds AND
        every sample inside the trailing ``for_s`` satisfies ``pred`` —
        one spiky sample can never trigger, and neither can a window too
        young to know what "sustained" means yet."""
        if not self._samples:
            return False
        horizon = now - float(for_s)
        if self._samples[0].t > horizon:
            return False  # not enough history to call anything sustained
        inside = [s for s in self._samples if s.t >= horizon]
        return bool(inside) and all(pred(s) for s in inside)


class SignalReader(_SampleWindow):
    """Samples the autoscaler's inputs into a rolling window.

    ``slo`` is any object with the :class:`~..obs.slo.SloBurn` snapshot
    surface, ``membership`` anything with the
    :class:`~..cluster.membership.Membership` read surface. ``window_s``
    bounds how much history is retained — it only needs to cover the
    policy's longest sustain window.
    """

    def __init__(self, *, slo, membership, clock: Callable[[], float],
                 burn_window: str = "1m", window_s: float = 120.0):
        super().__init__(window_s)
        self._slo = slo
        self._membership = membership
        self._clock = clock
        self.burn_window = str(burn_window)

    def sample(self) -> Sample:
        """Take one observation, append it, and age out old ones."""
        now = float(self._clock())
        burn: Dict[str, float] = {}
        burn_detail: Dict[str, float] = {}
        for model, classes in sorted(self._slo.snapshot().items()):
            for cls, stats in sorted(classes.items()):
                b = float((stats.get("burn") or {}).get(self.burn_window,
                                                        0.0))
                burn_detail[f"{model}/{cls}"] = b
                if b > burn.get(cls, -1.0):
                    burn[cls] = b
        queue_depth = 0
        kv = 0.0
        alive = 0
        for rid in self._membership.ids():
            if self._membership.state(rid) == DEAD:
                continue
            p = self._membership.payload(rid)
            queue_depth += int(p.get("queue_depth") or 0)
            kv = max(kv, float(p.get("kv_utilization") or 0.0))
            alive += 1
        return self._push(Sample(now, burn, burn_detail, queue_depth, kv,
                                 alive))


class StepTimeSignalReader(_SampleWindow):
    """Step-time regression as SLO burn — the training-side signal source.

    The elastic trainer has no request SLO; its contract is a **step-time
    budget**. Each observed step maps to burn ``step_time / budget_s``
    under the single ``"train"`` class, so the stock
    :class:`~.policy.AutoscalePolicy` applies UNCHANGED: burn >= 1.0
    (steps slower than budget) sustained over the out-window scales the
    mesh out; burn deep inside the hysteresis band (steps comfortably
    under budget) sustained over the in-window scales it in. Timestamps
    come from the injected clock — the elastic trainer passes its logical
    step clock, so sustain/cooldown windows are measured in *steps* and
    the whole loop stays deterministic under test.
    """

    def __init__(self, *, budget_s: float, clock: Callable[[], float],
                 window_s: float = 120.0):
        super().__init__(window_s)
        if budget_s <= 0:
            raise ValueError("need budget_s > 0")
        self.budget_s = float(budget_s)
        self._clock = clock

    def observe(self, step_time_s: float, *, alive: int = 1) -> Sample:
        """Record one training step's duration as a burn sample."""
        now = float(self._clock())
        burn = float(step_time_s) / self.budget_s
        return self._push(Sample(now, {"train": burn},
                                 {"train/train": burn}, 0, 0.0,
                                 int(alive)))
