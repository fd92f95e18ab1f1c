"""Serving-config autotuner — seeded random search + successive halving;
the port's copy of ``deeplearning4j_tpu/sim/tune.py``.

The serving pipeline is treated as a tunable program (TVM, arXiv
1802.04799; Relay, 1810.00952): a candidate is a full knob dict
(``sim/replay.py`` schema), its fitness is the deterministic
:func:`~.score.score` of a :class:`~.replay.VirtualReplayer` run, and the
search is classic **successive halving** — every candidate is scored on a
short prefix of the trace, the top ``1/eta`` survive to a prefix
``eta``× longer, until the final rung replays the full trace. Cheap early
rungs pay for wide exploration; the expensive full replay is spent on a
handful of finalists.

Two guarantees the smoke gate relies on:

- the **hand-picked default is candidate 0 and is never eliminated** — it
  rides every rung to the end, so the winner's full-trace score is ≥ the
  default's by construction (a config that only looked good on a prefix
  cannot beat the default by eliminating it early);
- everything is seeded and tie-broken by candidate index, so the same
  (trace, space, seed) always produces the same winner.

Winners persist into the AOT store via :func:`record_winner`, keyed by
(runtime/topology fingerprint, workload fingerprint) — see
``aot/tuned.py`` — so a booting replica resolves its tuned config the
same way it resolves its compiled executables.
"""

from __future__ import annotations

import copy
import json
import random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .replay import (CostModel, DEFAULT_KNOBS, VirtualReplayer, merge_knobs,
                     set_flat)
from .score import score as score_report
from .workload import Trace

# Searched knobs and their candidate values. cluster.* knobs ride along in
# the recorded config but are NOT searched: the virtual cost model does not
# differentiate hedging/retry behavior (deeplearning4j_tpu/sim/README.md).
# autoscale.* knobs (forecast season/horizon/confidence floor) are
# searchable the same way —
# pass a space with `autoscale.forecast_*` keys; the winner's group feeds
# AutoscalePolicy.from_config and BurnForecaster.from_config.
DEFAULT_SPACE: Dict[str, Sequence] = {
    "engine.max_wait_ms": (0.5, 1.0, 2.0, 4.0, 8.0),
    "engine.queue_limit": (64, 128, 256, 512),
    "gen.slots": (2, 4, 8, 16),
    "gen.block_size": (8, 16, 32),
    "gen.prefill_chunk": (16, 32, 64, 128),
    "gen.decode_chunks": (1, 2, 4),
    "gen.queue_limit": (32, 64, 128),
    # prefix caching: whether to share whole-block prompt prefixes, and
    # how many pool blocks the cache may pin (None = bounded only by
    # capacity pressure via the reclaimer). Only differentiating when the
    # trace carries shared-prefix traffic (WorkloadSpec prefix_reuse > 0);
    # on legacy traces every candidate scores identically here.
    "gen.prefix_cache": (True, False),
    "gen.prefix_cache_blocks": (None, 16, 64),
}


class TuneResult(NamedTuple):
    """Search outcome: the winning knob dict plus its audit trail."""

    winner: dict
    winner_score: float
    default_score: float
    winner_report: dict
    evaluated: int              # total replay evaluations across rungs
    rungs: List[dict]           # per-rung: events, survivors, best score


def _canon(knobs: dict) -> str:
    return json.dumps(knobs, sort_keys=True, separators=(",", ":"))


class Tuner:
    """Search ``space`` over ``trace``, starting from ``base`` knobs."""

    def __init__(self, trace: Trace, *, space: Optional[dict] = None,
                 base: Optional[dict] = None,
                 cost_model: Optional[CostModel] = None, seed: int = 0):
        self.trace = trace
        self.space = dict(space if space is not None else DEFAULT_SPACE)
        self.base = merge_knobs(DEFAULT_KNOBS, base)
        self.cost_model = cost_model
        self.seed = int(seed)

    @classmethod
    def from_store(cls, trace: Trace, store, model_fp: str, *,
                   runtime: Optional[dict] = None, metrics=None,
                   **kwargs) -> "Tuner":
        """Boot with a **measured** cost model when the AOT store holds a
        profiler-captured :class:`~deeplearning4j_torch.obs.costmodel
        .CostProfile` for (current runtime fingerprint, ``model_fp``) —
        resolution is counted on ``profile_store_hits_total`` /
        ``_misses_total``. A miss boots ``cost_model=None`` (the hand-set
        defaults), so virtual reports without a profile stay byte-identical
        to a plain :class:`Tuner`."""
        from ..obs.costmodel import get_profile

        profile = get_profile(store, model_fp, runtime=runtime,
                              metrics=metrics)
        if profile is not None:
            kwargs.setdefault("cost_model", CostModel.from_profile(profile))
        return cls(trace, **kwargs)

    def _sample(self, rng: random.Random) -> dict:
        cand = copy.deepcopy(self.base)
        for key in sorted(self.space):
            set_flat(cand, key, rng.choice(list(self.space[key])))
        return cand

    def _population(self, n: int) -> List[dict]:
        """Default first, then deduped random samples."""
        rng = random.Random(self.seed)
        pop = [copy.deepcopy(self.base)]
        seen = {_canon(self.base)}
        attempts = 0
        while len(pop) < n and attempts < n * 20:
            cand = self._sample(rng)
            attempts += 1
            key = _canon(cand)
            if key not in seen:
                seen.add(key)
                pop.append(cand)
        return pop

    def evaluate(self, knobs: dict, n_events: Optional[int] = None) -> dict:
        sliced = (self.trace if n_events is None
                  else self.trace.slice(n_events))
        return VirtualReplayer(sliced, knobs=knobs,
                               cost_model=self.cost_model).run()

    def search(self, candidates: int = 16, eta: int = 3,
               min_events: int = 128) -> TuneResult:
        """Successive halving; returns the full-trace winner."""
        pop = self._population(max(2, int(candidates)))
        n_total = max(1, len(self.trace))
        rung_events: List[int] = []
        b = min(min_events, n_total)
        while b < n_total:
            rung_events.append(b)
            b *= eta
        rung_events.append(n_total)

        # survivors carry (original_index, knobs); index 0 is the default
        survivors: List[Tuple[int, dict]] = list(enumerate(pop))
        evaluated = 0
        rungs: List[dict] = []
        scores: List[Tuple[float, int, dict, dict]] = []
        for depth, n_events in enumerate(rung_events):
            scores = []
            for idx, knobs in survivors:
                report = self.evaluate(knobs, n_events)
                evaluated += 1
                scores.append((float(report["score"]), idx, knobs, report))
            # stable rank: higher score first, earlier candidate on ties —
            # so re-runs are bit-identical and the default wins ties
            scores.sort(key=lambda s: (-s[0], s[1]))
            keep = max(2, len(scores) // max(2, int(eta)))
            if depth == len(rung_events) - 1:
                keep = len(scores)
            kept = scores[:keep]
            if not any(idx == 0 for _, idx, _, _ in kept):
                kept.append(next(s for s in scores if s[1] == 0))
            rungs.append({"events": n_events,
                          "candidates": len(scores),
                          "survivors": len(kept),
                          "best_score": kept[0][0]})
            survivors = [(idx, knobs) for _, idx, knobs, _ in kept]

        best_score, best_idx, best_knobs, best_report = scores[0]
        default_score = next(s[0] for s in scores if s[1] == 0)
        return TuneResult(winner=best_knobs, winner_score=best_score,
                          default_score=default_score,
                          winner_report=best_report, evaluated=evaluated,
                          rungs=rungs)


def record_winner(store, trace: Trace, result: TuneResult, *,
                  runtime: Optional[dict] = None) -> Optional[str]:
    """Persist the winner into the AOT store keyed by (runtime fingerprint,
    workload fingerprint); returns the store key (None if the put failed)."""
    from ..aot.tuned import put_tuned

    meta = {"score": result.winner_score,
            "default_score": result.default_score,
            "evaluated": result.evaluated}
    return put_tuned(store, trace.fingerprint(), result.winner,
                     runtime=runtime, extra_meta=meta)
