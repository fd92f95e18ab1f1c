"""Dropout variants, weight noise and weight constraints — counterpart of
``deeplearning4j_tpu/ops/regularization.py``.

Every random op draws from an explicit ``torch.Generator`` (the port's
``rng``), on the input's device; the reference draws from a JAX key, so
the two packages give other masks from one seed, and tests compare the
masks' statistics. ``rate`` is the drop probability. Inverted dropout
keeps ``x / keep`` where a unit is kept and 0 where it is dropped, as
the reference's ``jnp.where(mask, x / keep, 0.0)``: a division in x's
dtype, not a product with the reciprocal, with every Python constant
rounded to x's dtype first as JAX rounds a weakly typed scalar
(``weak_scalar``), so a bf16 input rounds as the reference's does. Constraints are the reference's projections, applied
to a weight after an update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from .activations import weak_scalar
from .updaters import tree_leaves, tree_unflatten


def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """f32 draws in [0, 1); ``uniform(...) < keep`` keeps with
    probability ``keep``, as ``jax.random.bernoulli`` does."""
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def normal_like(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Standard normal draws of x's shape, dtype and device."""
    return torch.randn(x.shape, generator=gen, dtype=x.dtype,
                       device=x.device)


def _inverted(x: torch.Tensor, kept: torch.Tensor, keep: float):
    return torch.where(kept, x / weak_scalar(keep, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# --- dropout (activation noise) ---

def dropout(gen, x: torch.Tensor, rate: float,
            training: bool = True) -> torch.Tensor:
    """Inverted dropout: each unit kept with probability ``1 - rate``."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return _inverted(x, uniform(gen, x.shape, x.device) < keep, keep)


def spatial_dropout(gen, x: torch.Tensor, rate: float,
                    training: bool = True) -> torch.Tensor:
    """Drop whole feature maps: one draw per (example, channel) of an
    NHWC (channels-last) input."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return _inverted(x, uniform(gen, shape, x.device) < keep, keep)


def alpha_dropout(gen, x: torch.Tensor, rate: float,
                  training: bool = True) -> torch.Tensor:
    """SELU-compatible dropout (Klambauer et al.): dropped units take
    alpha' and the output is rescaled to keep mean and variance."""
    if not training or rate <= 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - rate
    kept = uniform(gen, x.shape, x.device) < keep
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    dt = x.dtype
    return weak_scalar(a, dt) * torch.where(kept, x, torch.full(
        (), alpha_p, dtype=dt, device=x.device)) + weak_scalar(b, dt)


def gaussian_dropout(gen, x: torch.Tensor, rate: float,
                     training: bool = True) -> torch.Tensor:
    """Multiplicative N(1, rate / (1 - rate)) noise."""
    if not training or rate <= 0.0:
        return x
    std = weak_scalar(math.sqrt(rate / (1.0 - rate)), x.dtype)
    return x * (1.0 + std * normal_like(gen, x))


def gaussian_noise(gen, x: torch.Tensor, stddev: float,
                   training: bool = True) -> torch.Tensor:
    """Additive N(0, stddev²) noise."""
    if not training or stddev <= 0.0:
        return x
    return x + weak_scalar(stddev, x.dtype) * normal_like(gen, x)


DROPOUTS: Dict[str, Callable] = {
    "dropout": dropout,
    "spatial": spatial_dropout,
    "alpha": alpha_dropout,
    "gaussian_dropout": gaussian_dropout,
    "gaussian_noise": gaussian_noise,
}


def apply_dropout_config(gen, x: torch.Tensor, cfg,
                         training: bool) -> torch.Tensor:
    """``cfg``: a float (the dropout rate) or ``{"type": name, ...}``
    with the keyword arguments of one of ``DROPOUTS``."""
    if cfg is None:
        return x
    if isinstance(cfg, (int, float)):
        return dropout(gen, x, float(cfg), training)
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return DROPOUTS[kind](gen, x, training=training, **cfg)


# --- weight noise (applied to params for one forward pass) ---

def weight_noise(gen, params, stddev: float = 0.01, additive: bool = True,
                 training: bool = True):
    """WeightNoise: a params tree perturbed for one forward pass (not
    kept), leaf by leaf in ``tree_leaves`` order."""
    if not training or stddev <= 0.0:
        return params
    leaves = tree_leaves(params)
    if additive:
        noised = [p + stddev * normal_like(gen, p) for p in leaves]
    else:
        noised = [p * (1.0 + stddev * normal_like(gen, p)) for p in leaves]
    return tree_unflatten(params, noised)


def drop_connect(gen, params, rate: float = 0.5, training: bool = True):
    """DropConnect: every weight kept with probability ``1 - rate`` (and
    scaled by its inverse) for one forward pass."""
    if not training or rate <= 0.0:
        return params
    keep = 1.0 - rate
    return tree_unflatten(params, [
        _inverted(p, uniform(gen, p.shape, p.device) < keep, keep)
        for p in tree_leaves(params)])


# --- weight constraints (post-update projections) ---

def _norms(w: torch.Tensor, axis) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(w), dim=axis, keepdim=True))


def max_norm(w: torch.Tensor, max_val: float = 2.0, axis=0) -> torch.Tensor:
    norms = _norms(w, axis)
    # a tensor numerator: a Python scalar over a tensor is computed by
    # torch as the reciprocal times the scalar, two roundings
    ratio = torch.full((), max_val, dtype=w.dtype, device=w.device) \
        / torch.clamp(norms, min=1e-8)
    return w * torch.clamp(ratio, max=1.0)


def min_max_norm(w: torch.Tensor, min_val: float = 0.0, max_val: float = 1.0,
                 rate: float = 1.0, axis=0) -> torch.Tensor:
    norms = _norms(w, axis)
    clipped = torch.clamp(norms, min_val, max_val)
    target = rate * clipped + (1.0 - rate) * norms
    return w * (target / torch.clamp(norms, min=1e-8))


def unit_norm(w: torch.Tensor, axis=0) -> torch.Tensor:
    return w / torch.clamp(_norms(w, axis), min=1e-8)


def non_negative(w: torch.Tensor) -> torch.Tensor:
    return torch.clamp(w, min=0.0)


CONSTRAINTS: Dict[str, Callable] = {
    "max_norm": max_norm,
    "min_max_norm": min_max_norm,
    "unit_norm": unit_norm,
    "non_negative": non_negative,
}


def apply_constraint_config(w: torch.Tensor, cfg) -> torch.Tensor:
    """``cfg``: a constraint's name or ``{"type": name, ...}``."""
    if cfg is None:
        return w
    if isinstance(cfg, str):
        return CONSTRAINTS[cfg](w)
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return CONSTRAINTS[kind](w, **cfg)
