"""Learning-rate / value schedules — counterpart of
``deeplearning4j_tpu/ops/schedules.py``.

A schedule is a pure function of the step count, ``f(count) -> value``: the
count is an int tensor (an updater's state, on the params' device) or a
Python int, and the value a float32 tensor on the count's device, computed
in float32 as the reference computes it, so the updater never reads the
count back to the host. Every schedule works in iterations;
:func:`per_epoch` wraps an epoch-based one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Union

import torch

Schedule = Callable  # (count) -> value
ScalarOrSchedule = Union[float, Schedule]


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def constant(value: float) -> Schedule:
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=torch.as_tensor(count).device)


def exponential(initial: float, gamma: float) -> Schedule:
    """value = initial * gamma^iter (ExponentialSchedule)."""
    return lambda count: initial * torch.pow(gamma, _f32(count))


def inverse(initial: float, gamma: float, power: float) -> Schedule:
    """value = initial / (1 + gamma*iter)^power (InverseSchedule)."""
    return lambda count: initial / torch.pow(1.0 + gamma * _f32(count), power)


def poly(initial: float, power: float, max_iter: int) -> Schedule:
    """value = initial * (1 - iter/maxIter)^power (PolySchedule)."""

    def fn(count):
        frac = torch.clamp(_f32(count) / max_iter, 0.0, 1.0)
        return initial * torch.pow(1.0 - frac, power)

    return fn


def sigmoid_schedule(initial: float, gamma: float, step_size: int) -> Schedule:
    """value = initial / (1 + exp(-gamma*(iter - stepSize))) (SigmoidSchedule)."""
    return lambda count: initial / (1.0 + torch.exp(-gamma * (_f32(count)
                                                              - step_size)))


def step_schedule(initial: float, decay_rate: float, step_size: int) -> Schedule:
    """value = initial * decayRate^floor(iter/step) (StepSchedule)."""
    return lambda count: initial * torch.pow(
        decay_rate, torch.floor(_f32(count) / step_size))


def map_schedule(values: Dict[int, float]) -> Schedule:
    """Piecewise-constant from {iteration: value} (MapSchedule)."""
    boundaries = sorted(values)
    vals = [values[b] for b in boundaries]

    def fn(count):
        c = _f32(count)
        out = torch.full_like(c, vals[0])
        for b, v in zip(boundaries, vals):
            out = torch.where(c >= b, torch.full_like(c, v), out)
        return out

    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  end_value: float = 0.0) -> Schedule:
    """Linear warmup, then cosine decay to ``end_value``."""

    def fn(count):
        c = _f32(count)
        warm = peak * c / max(warmup_steps, 1)
        frac = torch.clamp((c - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = end_value + 0.5 * (peak - end_value) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(c < warmup_steps, warm, cos)

    return fn


def per_epoch(schedule: Schedule, steps_per_epoch: int) -> Schedule:
    """Evaluate an epoch-based schedule from the iteration counter."""
    return lambda count: schedule(torch.as_tensor(count) // steps_per_epoch)


_BUILDERS = {
    "constant": constant,
    "exponential": exponential,
    "inverse": inverse,
    "poly": poly,
    "sigmoid": sigmoid_schedule,
    "step": step_schedule,
    "map": map_schedule,
    "warmup_cosine": warmup_cosine,
}


def from_config(cfg: Union[float, dict, Schedule]) -> Schedule:
    """Build a schedule from JSON-able config: {"type": "step", "initial": .1, ...}."""
    if callable(cfg):
        return cfg
    if isinstance(cfg, (int, float)):
        return constant(cfg)
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return _BUILDERS[kind](**cfg)
