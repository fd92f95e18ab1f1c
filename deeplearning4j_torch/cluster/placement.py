"""Model placement — bin-pack weights onto replicas, re-place on death;
the port's copy of ``deeplearning4j_tpu/cluster/placement.py``.

The placement planner answers one question for the router: *in what order
should replicas be tried for model X right now?* Its output is a candidate
list per model — ``candidates[0]`` is the primary (the replica whose HBM
the model should occupy), the tail is the failover/spill order.

Primary assignment is first-fit-decreasing bin-packing: models sorted by
``weight_bytes`` descending, each placed on the live replica with the most
*remaining* budget that still fits it (worst-fit keeps the load spread
instead of stacking one box full — the framing of the cross-replica
sharding literature in PAPERS.md, arXiv 2004.13336). A model that fits on
no replica alone still gets a primary (the emptiest replica): the
replica-side LRU pager will thrash it in and out, which is degraded but
correct — placement must never return "nowhere".

The failover tail is every other replica ordered by load (self-reported
queue depth, then free budget): a failed-over request should land on the
replica with the most headroom *at plan time*. Plans are recomputed by the
router whenever membership or residency changes — death re-places
naturally because a dead replica simply is not in ``replicas`` any more.

The planner is pure (dicts in, dict out, no clock, no I/O): every
placement decision is unit-testable by constructing the inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class Placement:
    """Stateless bin-pack planner + a counter for rebuilds."""

    def __init__(self, metrics=None):
        self._metrics = metrics

    def plan(self, models: Dict[str, int],
             replicas: Dict[str, dict]) -> Dict[str, List[str]]:
        """``models``: name -> weight_bytes. ``replicas``: replica_id ->
        ``{"hbm_budget_bytes": int|None, "queue_depth": int}`` (the beat
        self-reports, live replicas only). Returns name -> ordered
        candidate replica ids (primary first); ``{}`` when no replicas."""
        if not replicas:
            return {}
        if self._metrics is not None:
            self._metrics.counter(
                "cluster_placement_rebuilds_total",
                help="placement plans recomputed (membership or "
                     "residency changed)").inc()
        free: Dict[str, float] = {}
        for rid, rep in replicas.items():
            budget = rep.get("hbm_budget_bytes")
            free[rid] = float("inf") if budget is None else float(budget)
        order = sorted(models, key=lambda n: (-int(models[n]), n))
        primaries: Dict[str, str] = {}
        for name in order:
            w = int(models[name])
            fits = [r for r in free if free[r] >= w]
            pool = fits if fits else list(free)
            # worst-fit: most remaining budget first; replica id tiebreak
            # keeps the plan deterministic under equal budgets
            primary = max(pool, key=lambda r: (free[r], r))
            primaries[name] = primary
            free[primary] -= w
        out: Dict[str, List[str]] = {}
        for name, primary in primaries.items():
            rest = [r for r in replicas if r != primary]
            rest.sort(key=lambda r: (int(replicas[r].get("queue_depth", 0)),
                                     -free[r], r))
            out[name] = [primary] + rest
        return out

    @staticmethod
    def primary(plan: Dict[str, List[str]], name: str) -> Optional[str]:
        cands = plan.get(name)
        return cands[0] if cands else None
