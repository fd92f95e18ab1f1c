"""Updaters — counterpart of ``deeplearning4j_tpu/ops/updaters.py``.

The reference builds optax gradient transformations; the port writes its
own, with the same math and the same state layout:

- a :class:`Transform` is ``init(params) -> state`` and
  ``update(grads, state, params) -> (updates, state)`` over flat lists of
  tensors, in the order :func:`tree_leaves` gives a params dict (keys
  sorted at every level, as ``jax.tree_util`` orders them);
- the states are optax's: ``AdamState(count, mu, nu)``,
  ``ScheduleState(count)`` and the empty tuple, chained in tuples, so
  ``tree_leaves(state)`` lists the leaves in optax's order and an updater
  state crosses between the packages leaf for leaf
  (``train/serialization.py``).

``adam`` is optax's ``scale_by_adam`` (bias correction at ``count + 1``,
with ``decay ** count`` by squaring in f32 as XLA computes it, ``eps``
outside the square root) then ``-learning_rate``; ``adamw`` adds
``weight_decay * param`` on EVERY param before the learning rate, as
optax's ``adamw`` with no mask does (biases and LayerNorm gains decay
too). ``build`` prepends the l2 and l1 terms in the reference's order. The
other updaters and gradient normalization raise ``NotImplementedError``.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from . import schedules as sched

ScalarOrSchedule = Union[float, Callable]
_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1: slice 2 left-outs)"


def tree_leaves(tree) -> List[Any]:
    """Leaves of a tree of dicts, tuples and lists, in ``jax.tree_util``'s
    order: dict keys sorted, sequences in order, ``None`` and empty
    containers contribute nothing."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(template, leaves: Sequence[Any]):
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            filled = {k: build(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


class Transform(NamedTuple):
    init: Callable[[List[torch.Tensor]], Any]
    update: Callable[..., Any]


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ScheduleState(NamedTuple):
    count: torch.Tensor


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=params[0].device if params else None)


def _int_pow(base: float, count: torch.Tensor) -> torch.Tensor:
    """``base ** count`` in f32 by squaring, bit by bit, as XLA computes
    ``pow(f32, s32)`` (a correctly rounded pow differs by an ulp or two,
    which ``1 - base**count`` magnifies). On the count's device, no sync."""
    acc = torch.ones((), dtype=torch.float32, device=count.device)
    b = torch.full((), base, dtype=torch.float32, device=count.device)
    for bit in range(31):
        acc = torch.where(((count >> bit) & 1).bool(), acc * b, acc)
        b = b * b
    return acc


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def init(params):
        return AdamState(_count(params), [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        g = list(updates)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
        count = state.count + 1
        out = torch._foreach_div(mu, 1 - _int_pow(b1, count))
        den = torch._foreach_div(nu, 1 - _int_pow(b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(out, den)
        return out, AdamState(count, mu, nu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """updates + weight_decay * params, on every param."""

    def update(updates, state, params=None):
        return torch._foreach_add(list(updates),
                                  torch._foreach_mul(list(params), weight_decay)), state

    return Transform(lambda params: (), update)


def add_l1(l1: float) -> Transform:
    def update(updates, state, params=None):
        return torch._foreach_add(
            list(updates), torch._foreach_mul([torch.sign(p) for p in params], l1)), state

    return Transform(lambda params: (), update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule) -> Transform:
    """updates * -learning_rate(count); the count is the state."""
    lr = sched.from_config(learning_rate)

    def init(params):
        return ScheduleState(_count(params))

    def update(updates, state, params=None):
        step = -1 * lr(state.count)
        return torch._foreach_mul(list(updates), step), ScheduleState(state.count + 1)

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def multi_transform(transforms: Dict[str, Transform],
                    labels: Sequence[str]) -> Transform:
    """Per-label transforms (optax ``multi_transform``): ``labels[i]``
    names the transform of leaf i. The state is ``{label: inner_state}``,
    each inner state over its own leaves in order, so its leaves follow
    optax's (labels sorted, masked-out leaves absent)."""
    labels = list(labels)
    idx = {name: [i for i, lb in enumerate(labels) if lb == name]
           for name in transforms}

    def init(params):
        return {name: t.init([params[i] for i in idx[name]])
                for name, t in transforms.items()}

    def update(updates, state, params=None):
        out: List[Optional[torch.Tensor]] = [None] * len(labels)
        new_state = {}
        for name, t in transforms.items():
            sub_p = None if params is None else [params[i] for i in idx[name]]
            sub_u, new_state[name] = t.update([updates[i] for i in idx[name]],
                                              state[name], sub_p)
            for i, u in zip(idx[name], sub_u):
                out[i] = u
        return out, new_state

    return Transform(init, update)


_REGISTRY: Dict[str, Callable[..., Transform]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def names():
    return sorted(_REGISTRY)


@register("sgd")
def sgd(learning_rate: ScalarOrSchedule = 1e-1, **_):
    return chain(scale_by_learning_rate(learning_rate))


@register("adam")
def adam(learning_rate: ScalarOrSchedule = 1e-3, beta1: float = 0.9,
         beta2: float = 0.999, epsilon: float = 1e-8, **_):
    return chain(scale_by_adam(beta1, beta2, epsilon),
                 scale_by_learning_rate(learning_rate))


@register("adamw")
def adamw(learning_rate: ScalarOrSchedule = 1e-3, beta1: float = 0.9,
          beta2: float = 0.999, epsilon: float = 1e-8,
          weight_decay: float = 1e-2, **_):
    return chain(scale_by_adam(beta1, beta2, epsilon),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


# the JAX package's other updaters, refused by name rather than as unknown
_UNPORTED = ("nesterovs", "amsgrad", "adamax", "nadam", "adagrad", "adadelta",
             "rmsprop", "noop")


def _factory(kind: str):
    key = kind.lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"updater '{kind}' is {_NOT_PORTED}")
    return _REGISTRY[key]


def build(config: Union[str, dict, Transform],
          gradient_normalization: Optional[str] = None,
          gradient_normalization_threshold: float = 1.0,
          l1: float = 0.0, l2: float = 0.0) -> Transform:
    """The full update pipeline from a JSON-able updater config, in the
    reference's order: l2 (decayed weights), l1, gradient normalization,
    then the updater's math."""
    parts = []
    if l2:
        parts.append(add_decayed_weights(l2))
    if l1:
        parts.append(add_l1(l1))
    if gradient_normalization and gradient_normalization.lower() != "none":
        raise NotImplementedError(f"gradient normalization "
                                  f"'{gradient_normalization}' is {_NOT_PORTED}")
    if isinstance(config, Transform):
        parts.append(config)
    elif isinstance(config, str):
        parts.append(_factory(config)())
    else:
        cfg = dict(config)
        kind = cfg.pop("type")
        if "lr" in cfg:
            cfg["learning_rate"] = cfg.pop("lr")
        factory = _factory(kind)
        known = set(inspect.signature(factory).parameters)
        unknown = set(cfg) - known
        if unknown:  # every factory takes **_: a typo would pass silently
            logging.getLogger(__name__).warning(
                "updater '%s': ignoring unknown config keys %s (known: %s)",
                kind, sorted(unknown), sorted(known - {"_"}))
        parts.append(factory(**cfg))
    return chain(*parts) if len(parts) > 1 else parts[0]
