"""Updaters — counterpart of ``deeplearning4j_tpu/ops/updaters.py``.

The reference builds optax gradient transformations; the port writes its
own, with the same math and the same state layout:

- a :class:`Transform` is ``init(params) -> state`` and
  ``update(grads, state, params) -> (updates, state)`` over flat lists of
  tensors, in the order :func:`tree_leaves` gives a params dict (keys
  sorted at every level, as ``jax.tree_util`` orders them);
- the states are optax's: ``AdamState(count, mu, nu)``,
  ``ScaleByRmsState(nu)``, ``ScheduleState(count)`` and the empty tuple,
  chained in tuples, so
  ``tree_leaves(state)`` lists the leaves in optax's order and an updater
  state crosses between the packages leaf for leaf
  (``train/serialization.py``).

``adam`` is optax's ``scale_by_adam`` (bias correction at ``count + 1``,
with ``decay ** count`` a pow in f32 as XLA computes it, ``eps``
outside the square root) then ``-learning_rate``; ``adamw`` adds
``weight_decay * param`` on EVERY param before the learning rate, as
optax's ``adamw`` with no mask does (biases and LayerNorm gains decay
too). ``rmsprop`` is optax's ``rmsprop`` as the reference configures it
(``scale_by_rms``: ``nu`` from 0, ``nu = (1 - decay) g^2 + decay nu``, then
``g * rsqrt(nu + eps)``; then ``-learning_rate``). The other updaters are
optax's as the reference builds them, with optax's defaults where the
reference leaves them: ``nesterovs`` is ``trace(nesterov=True)`` then the
learning rate; ``amsgrad`` keeps ``nu_max``; ``adamax`` an infinity norm;
``nadam`` is ``scale_by_adam(nesterov=True)``; ``adagrad`` starts its
accumulator at 0.1; ``adadelta`` runs at learning rate 1.0 (a plain scale,
no count); ``noop`` is ``set_to_zero`` (its update is None: the trainer
adds nothing, and a frozen leaf needs no gradient).

``build`` prepends the l2 and l1 terms and the gradient normalization in
the reference's order. The per-layer normalizations take a "layer" to be
the top-level key of the params dict: ``owners`` names the key of each
leaf (``train.trainer._leaf_owners``), and under ``multi_transform`` each
branch is built with the owners of its own leaves, so a frozen or
overridden leaf is left out of the default branch's norms as optax's
masked tree leaves it out.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from . import schedules as sched

ScalarOrSchedule = Union[float, Callable]


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


class ScaleByRmsState(NamedTuple):
    nu: List[torch.Tensor]


class ScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: List[torch.Tensor]


class AmsgradState(NamedTuple):
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    nu_max: List[torch.Tensor]


class RssState(NamedTuple):
    sum_of_squares: List[torch.Tensor]


class AdaDeltaState(NamedTuple):
    e_g: List[torch.Tensor]
    e_x: List[torch.Tensor]


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=params[0].device if params else None)


def _int_pow(base: float, count: torch.Tensor) -> torch.Tensor:
    """``base ** count`` in f32 as optax's bias correction gets it from XLA
    (``pow`` of the f32 base and the count as f32): ``torch.pow`` of the
    two agrees with XLA's CPU result bit for bit wherever ``1 - base **
    count`` can tell (they part only where the power is subnormal), while
    repeated squaring is an ulp off at some counts (0.999 ** 3), which
    ``1 - base ** count`` magnifies. On the count's device, no sync."""
    return torch.pow(torch.full((), base, dtype=torch.float32,
                                device=count.device),
                     count.to(torch.float32))


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


def scale_by_adam_nesterov(b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-8) -> Transform:
    """optax's ``scale_by_adam(nesterov=True)`` (nadam): the first moment
    bias-corrected at ``count + 2`` and the gradient at ``count + 1``,
    mixed as ``b1 * m + (1 - b1) * g``."""
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
        m_hat = torch._foreach_div(mu, 1 - _int_pow(b1, count + 1))
        g_hat = torch._foreach_div(g, 1 - _int_pow(b1, count))
        out = torch._foreach_add(torch._foreach_mul(m_hat, b1),
                                 torch._foreach_mul(g_hat, 1 - b1))
        den = torch._foreach_div(nu, 1 - _int_pow(b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(out, den)
        return out, AdamState(count, mu, nu)

    return Transform(init, update)


def scale_by_amsgrad(b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8) -> Transform:
    """optax's ``scale_by_amsgrad``: adam's moments, the running maximum
    of the bias-corrected second moment (``nu_max``) in the denominator."""
    def init(params):
        z = lambda: [torch.zeros_like(p) for p in params]
        return AmsgradState(_count(params), z(), z(), z())

    def update(updates, state, params=None):
        g = list(updates)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
        count = state.count + 1
        out = torch._foreach_div(mu, 1 - _int_pow(b1, count))
        nu_hat = torch._foreach_div(nu, 1 - _int_pow(b2, count))
        nu_max = torch._foreach_maximum(state.nu_max, nu_hat)
        den = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(out, den)
        return out, AmsgradState(count, mu, nu, nu_max)

    return Transform(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> Transform:
    """optax's ``scale_by_adamax``: ``nu = max(|g| + eps, b2 nu)``, the
    bias-corrected first moment over it (its state is adam's)."""
    def init(params):
        return AdamState(_count(params), [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        g = list(updates)
        count = state.count + 1
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_maximum(torch._foreach_add(torch._foreach_abs(g), eps),
                                    torch._foreach_mul(state.nu, b2))
        out = torch._foreach_div(mu, 1 - _int_pow(b1, count))
        return torch._foreach_div(out, nu), AdamState(count, mu, nu)

    return Transform(init, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    """optax's ``trace``: ``t = g + decay t``; the update is ``t`` or, with
    ``nesterov``, ``g + decay t``."""
    def init(params):
        return TraceState([torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        g = list(updates)
        t = torch._foreach_add(g, torch._foreach_mul(state.trace, decay))
        out = torch._foreach_add(g, torch._foreach_mul(t, decay)) \
            if nesterov else t
        return out, TraceState(t)

    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Transform:
    """optax's ``scale_by_rss`` (adagrad): the sum of squares from
    ``initial_accumulator_value``, ``g * rsqrt(sum + eps)`` where the sum
    is positive, else 0."""
    def init(params):
        return RssState([torch.full_like(p, initial_accumulator_value)
                         for p in params])

    def update(updates, state, params=None):
        g = list(updates)
        sos = torch._foreach_add(torch._foreach_mul(g, g), state.sum_of_squares)
        inv = [torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
               for s in sos]
        return torch._foreach_mul(inv, g), RssState(sos)

    return Transform(init, update)


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6) -> Transform:
    """optax's ``scale_by_adadelta``: ``e_g`` and ``e_x`` moving averages of
    the squared gradient and the squared update."""
    def init(params):
        return AdaDeltaState([torch.zeros_like(p) for p in params],
                             [torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        g = list(updates)
        e_g = torch._foreach_mul(g, g)
        torch._foreach_mul_(e_g, 1 - rho)
        torch._foreach_add_(e_g, torch._foreach_mul(state.e_g, rho))
        num = torch._foreach_sqrt(torch._foreach_add(state.e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        out = torch._foreach_mul(torch._foreach_div(num, den), g)
        e_x = torch._foreach_mul(out, out)
        torch._foreach_mul_(e_x, 1 - rho)
        torch._foreach_add_(e_x, torch._foreach_mul(state.e_x, rho))
        return out, AdaDeltaState(e_g, e_x)

    return Transform(init, update)


def scale(step: float) -> Transform:
    """updates * step (optax's ``scale``: no state)."""
    def update(updates, state, params=None):
        return torch._foreach_mul(list(updates), step), state

    return Transform(lambda params: (), update)


def set_to_zero() -> Transform:
    """optax's ``set_to_zero``: a zero update, given as None per leaf so
    the caller adds nothing (and needs no gradient for the leaf)."""
    def update(updates, state, params=None):
        return [None] * len(updates), state

    return Transform(lambda params: (), update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> Transform:
    """optax's ``scale_by_rms`` (``initial_scale=0``, eps inside the
    square root, no bias correction), op for op."""
    def init(params):
        return ScaleByRmsState([torch.zeros_like(p) for p in params])

    def update(updates, state, params=None):
        g = list(updates)
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - decay)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, decay))
        scale = [torch.rsqrt(n) for n in torch._foreach_add(nu, eps)]
        return torch._foreach_mul(scale, g), ScaleByRmsState(nu)

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


def build_multi(label_fn, transforms: Dict[str, Transform]) -> Transform:
    """Per-layer updater overrides (optax ``multi_transform`` with a label
    function): ``label_fn(leaves)`` names the transform of each leaf (a
    sequence of labels may be given instead). The labels are read from the
    params at ``init`` and from the updates at each ``update``, as optax
    reads them; the state is :func:`multi_transform`'s."""
    def labels_of(leaves):
        return list(label_fn(leaves) if callable(label_fn) else label_fn)

    def init(params):
        return multi_transform(transforms, labels_of(params)).init(params)

    def update(updates, state, params=None):
        return multi_transform(transforms, labels_of(updates)).update(
            updates, state, params)

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


@register("rmsprop")
def rmsprop(learning_rate: ScalarOrSchedule = 1e-1, rms_decay: float = 0.95,
            epsilon: float = 1e-8, **_):
    return chain(scale_by_rms(rms_decay, epsilon),
                 scale_by_learning_rate(learning_rate))


@register("nesterovs")
def nesterovs(learning_rate: ScalarOrSchedule = 1e-1, momentum: float = 0.9,
              **_):
    return chain(trace(momentum, nesterov=True),
                 scale_by_learning_rate(learning_rate))


@register("amsgrad")
def amsgrad(learning_rate: ScalarOrSchedule = 1e-3, beta1: float = 0.9,
            beta2: float = 0.999, epsilon: float = 1e-8, **_):
    return chain(scale_by_amsgrad(beta1, beta2, epsilon),
                 scale_by_learning_rate(learning_rate))


@register("adamax")
def adamax(learning_rate: ScalarOrSchedule = 2e-3, beta1: float = 0.9,
           beta2: float = 0.999, epsilon: float = 1e-8, **_):
    return chain(scale_by_adamax(beta1, beta2, epsilon),
                 scale_by_learning_rate(learning_rate))


@register("nadam")
def nadam(learning_rate: ScalarOrSchedule = 1e-3, beta1: float = 0.9,
          beta2: float = 0.999, epsilon: float = 1e-8, **_):
    return chain(scale_by_adam_nesterov(beta1, beta2, epsilon),
                 scale_by_learning_rate(learning_rate))


@register("adagrad")
def adagrad(learning_rate: ScalarOrSchedule = 1e-1, epsilon: float = 1e-6,
            **_):
    return chain(scale_by_rss(0.1, epsilon),
                 scale_by_learning_rate(learning_rate))


@register("adadelta")
def adadelta(rho: float = 0.95, epsilon: float = 1e-6, **_):
    # optax's adadelta: decayed weights at 0 (no state), then a plain
    # scale by -1.0 (a float learning rate: no count)
    return chain(add_decayed_weights(0.0), scale_by_adadelta(rho, epsilon),
                 scale(-1.0))


@register("noop")
def noop(**_):
    return set_to_zero()


# --- gradient normalization (GradientNormalization) ---

def _groups(n: int, owners: Optional[Sequence[str]]) -> List[List[int]]:
    """Leaf indices grouped by layer (the top-level key each leaf belongs
    to, in first-seen order); one group of all leaves without owners."""
    if owners is None:
        return [list(range(n))]
    groups: Dict[str, List[int]] = {}
    for i, k in enumerate(owners):
        groups.setdefault(k, []).append(i)
    return list(groups.values())


def _layer_norm2(leaves) -> torch.Tensor:
    """sqrt of the sum over ``leaves`` of each leaf's sum of squares, added
    in leaf order."""
    total = None
    for g in leaves:
        sq = torch.sum(torch.square(g))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _per_layer(owners, scale_of) -> Transform:
    def update(updates, state, params=None):
        out = list(updates)
        for idx in _groups(len(out), owners):
            f = scale_of(_layer_norm2([out[i] for i in idx]))
            for i in idx:
                out[i] = f(out[i])
        return out, state

    return Transform(lambda params: (), update)


def renormalize_l2_per_layer(owners=None) -> Transform:
    """Each layer's gradients over the layer-wide L2 norm (at least
    1e-8)."""
    return _per_layer(owners, lambda n: lambda g: g / torch.clamp_min(n, 1e-8))


def clip_l2_per_layer(threshold: float, owners=None) -> Transform:
    """Each layer's gradients scaled by min(1, threshold / its L2 norm)."""
    def scale_of(n):
        # a tensor numerator: XLA's division, not a reciprocal times it
        f = torch.clamp_max(n.new_full((), threshold)
                            / torch.clamp_min(n, 1e-8), 1.0)
        return lambda g: g * f

    return _per_layer(owners, scale_of)


def renormalize_l2_per_param() -> Transform:
    def update(updates, state, params=None):
        return [g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-8)
                for g in updates], state

    return Transform(lambda params: (), update)


def clip_l2_per_param(threshold: float) -> Transform:
    def update(updates, state, params=None):
        return [g * torch.clamp_max(
            g.new_full((), threshold)
            / torch.clamp_min(torch.linalg.vector_norm(g), 1e-8), 1.0)
            for g in updates], state

    return Transform(lambda params: (), update)


def clip_elementwise(threshold: float) -> Transform:
    """optax's ``clip``: every entry into [-threshold, threshold]."""
    def update(updates, state, params=None):
        return [torch.clamp(g, -threshold, threshold) for g in updates], state

    return Transform(lambda params: (), update)


_GRADNORM = {
    "renormalizel2perlayer": lambda t, o: renormalize_l2_per_layer(o),
    "renormalizel2perparamtype": lambda t, o: renormalize_l2_per_param(),
    "clipelementwiseabsolutevalue": lambda t, o: clip_elementwise(t),
    "clipl2perlayer": lambda t, o: clip_l2_per_layer(t, o),
    "clipl2perparamtype": lambda t, o: clip_l2_per_param(t),
}


def build(config: Union[str, dict, Transform],
          gradient_normalization: Optional[str] = None,
          gradient_normalization_threshold: float = 1.0,
          l1: float = 0.0, l2: float = 0.0,
          owners: Optional[Sequence[str]] = None) -> Transform:
    """The full update pipeline from a JSON-able updater config, in the
    reference's order: l2 (decayed weights), l1, gradient normalization,
    then the updater's math. ``owners`` names each leaf's layer for the
    per-layer normalizations (all leaves one layer when None)."""
    parts = []
    if l2:
        parts.append(add_decayed_weights(l2))
    if l1:
        parts.append(add_l1(l1))
    if gradient_normalization and gradient_normalization.lower() != "none":
        key = gradient_normalization.lower().replace("_", "")
        if key not in _GRADNORM:
            raise ValueError(f"Unknown gradient normalization "
                             f"'{gradient_normalization}'")
        parts.append(_GRADNORM[key](gradient_normalization_threshold, owners))
    if isinstance(config, Transform):
        parts.append(config)
    elif isinstance(config, str):
        parts.append(_REGISTRY[config.lower()]())
    else:
        cfg = dict(config)
        kind = cfg.pop("type")
        if "lr" in cfg:
            cfg["learning_rate"] = cfg.pop("lr")
        factory = _REGISTRY[kind.lower()]
        known = set(inspect.signature(factory).parameters)
        unknown = set(cfg) - known
        if unknown:  # every factory takes **_: a typo would pass silently
            logging.getLogger(__name__).warning(
                "updater '%s': ignoring unknown config keys %s (known: %s)",
                kind, sorted(unknown), sorted(known - {"_"}))
        parts.append(factory(**cfg))
    return chain(*parts) if len(parts) > 1 else parts[0]
