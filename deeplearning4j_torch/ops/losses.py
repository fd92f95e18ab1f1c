"""Loss functions — counterpart of ``deeplearning4j_tpu/ops/losses.py``.

Each loss is ``fn(predictions, labels, mask=None, weights=None) -> scalar``:
the mean over examples (and timesteps) of the sum over output units, the
reference's ``computeScore(average=True)`` convention. Every loss of the
reference is here, under the reference's names and aliases, with masks and
weights through :func:`_reduce`; ``center_loss`` returns the loss and the
updated centers, as the reference's does. Integer labels one rank below
the predictions are class indices for ``mcxent`` and ``mcxent_logits``:
the target log-prob is gathered, and no (B, T, V) one-hot is ever built.
Constants are the reference's weak scalars, rounded to the predictions'
dtype (:func:`~.activations.weak_scalar`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .activations import clip, weak_scalar

_EPS = 1e-7

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


def _broadcast_mask(mask: torch.Tensor, shape) -> torch.Tensor:
    m = torch.as_tensor(mask).to(torch.float32)
    return m.reshape(tuple(m.shape) + (1,) * (len(shape) - m.ndim)).expand(shape)


def _reduce(per_unit: torch.Tensor, mask: Optional[torch.Tensor],
            weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Sum over the feature axis, mask per example/timestep, mean over the rest."""
    if weights is not None:
        per_unit = per_unit * weights
    per_example = per_unit.sum(dim=-1)
    if mask is None:
        return per_example.mean()
    m = _broadcast_mask(mask.to(per_example.device), per_example.shape) \
        .to(per_example.dtype)
    return (per_example * m).sum() / torch.clamp(m.sum(), min=1.0)


def reduction_mass(labels, mask=None) -> torch.Tensor:
    """Total denominator weight of one batch under :func:`_reduce`'s masked
    mean: ``sum(mask)`` broadcast to the per-example shape, or the
    per-example element count when unmasked. Integer labels are class
    indices (per-example shape == labels shape); dense labels lose the
    trailing class axis."""
    labels = torch.as_tensor(labels)
    sparse = not labels.is_floating_point()
    pe_shape = tuple(labels.shape) if sparse else tuple(labels.shape[:-1])
    if not pe_shape:
        pe_shape = (1,)
    if mask is None:
        # a fill on the labels' device: a tensor made on the host would be
        # copied from pageable memory, which waits for the device's queue
        return torch.full((), float(math.prod(pe_shape)),
                          dtype=torch.float32, device=labels.device)
    return _broadcast_mask(mask, pe_shape).sum()


def _is_sparse_labels(p, y) -> bool:
    """Sparse class-index labels = integer dtype AND one fewer trailing dim
    than predictions. Integer labels at full rank (one-hots cast to int)
    are ambiguous and raise."""
    y = torch.as_tensor(y)
    if y.is_floating_point():
        return False
    if y.ndim == p.ndim - 1:
        return True
    raise ValueError(
        f"integer labels with shape {tuple(y.shape)} are ambiguous against "
        f"predictions {tuple(p.shape)}: cast one-hot labels to float "
        f"for the dense loss, or drop the trailing class dim for sparse "
        f"class-index labels")


def _sparse_nll(logp, y, mask, weights):
    """Integer class-index labels: gather the target log-prob instead of a
    one-hot product."""
    idx = y.to(device=logp.device, dtype=torch.int64)[..., None]
    nll = -torch.gather(logp, -1, idx)[..., 0]
    if weights is not None:
        nll = nll * torch.gather(torch.as_tensor(weights).expand(logp.shape),
                                 -1, idx)[..., 0]
    return _reduce(nll[..., None], mask, None)


@register("mcxent")
@register("negativeloglikelihood")
def mcxent(p, y, mask=None, weights=None):
    """Multi-class cross-entropy on probabilities (post-softmax).
    Integer ``y`` of rank ``p.ndim - 1`` is treated as sparse class indices."""
    logp = torch.log(torch.clamp(p, _EPS, 1.0))
    if _is_sparse_labels(p, y):
        return _sparse_nll(logp, y, mask, weights)
    return _reduce(-y * logp, mask, weights)


@register("mcxent_logits")
@register("softmax_cross_entropy_logits")
def mcxent_logits(logits, y, mask=None, weights=None):
    """Fused softmax + cross-entropy on raw logits.
    Integer ``y`` of rank ``logits.ndim - 1`` is treated as sparse indices."""
    logp = torch.log_softmax(logits, dim=-1)
    if _is_sparse_labels(logits, y):
        return _sparse_nll(logp, y, mask, weights)
    return _reduce(-y * logp, mask, weights)


@register("mse")
@register("squared_loss")
def mse(p, y, mask=None, weights=None):
    return _reduce(torch.square(p - y), mask, weights)


@register("l2")
def l2(p, y, mask=None, weights=None):
    """The reference's L2: the sum of squared differences (as ``mse``,
    since the reduction sums over features)."""
    return _reduce(torch.square(p - y), mask, weights)


@register("l1")
def l1(p, y, mask=None, weights=None):
    return _reduce(torch.abs(p - y), mask, weights)


@register("mae")
def mae(p, y, mask=None, weights=None):
    return _reduce(torch.abs(p - y), mask, weights)


@register("xent")
@register("binary_crossentropy")
def xent(p, y, mask=None, weights=None):
    p = clip(p, _EPS, 1.0 - _EPS)
    return _reduce(-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)),
                   mask, weights)


@register("xent_logits")
@register("sigmoid_cross_entropy_logits")
def xent_logits(logits, y, mask=None, weights=None):
    """Sigmoid + binary cross-entropy on raw logits, in the
    ``log(1 + exp(-|x|))`` form."""
    per = (clip(logits, 0.0) - logits * y
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return _reduce(per, mask, weights)


@register("rmse_xent")
def rmse_xent(p, y, mask=None, weights=None):
    """The reference's legacy RMSE_XENT: sqrt of the squared difference
    per unit."""
    return _reduce(torch.sqrt(torch.square(p - y) + weak_scalar(_EPS, p.dtype)), mask,
                   weights)


def _plus_minus(y):
    """Labels in {0, 1} mapped to -1, +1 (float labels; integer labels are
    taken as they are)."""
    if not y.is_floating_point():
        return y
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(y > 0.5, one, -one)


@register("hinge")
def hinge(p, y, mask=None, weights=None):
    return _reduce(clip(1.0 - _plus_minus(y) * p, 0.0), mask, weights)


@register("squared_hinge")
def squared_hinge(p, y, mask=None, weights=None):
    return _reduce(torch.square(clip(1.0 - _plus_minus(y) * p, 0.0)),
                   mask, weights)


@register("kl_divergence")
@register("reconstruction_crossentropy")
def kl_divergence(p, y, mask=None, weights=None):
    p = clip(p, _EPS, 1.0)
    y_c = clip(y, _EPS, 1.0)
    return _reduce(y_c * (torch.log(y_c) - torch.log(p)), mask, weights)


@register("mean_absolute_percentage_error")
@register("mape")
def mape(p, y, mask=None, weights=None):
    eps = torch.full((), _EPS, dtype=y.dtype, device=y.device)
    den = torch.where(torch.abs(y) < _EPS, eps, y)
    return _reduce(100.0 * torch.abs((p - y) / den), mask, weights)


@register("mean_squared_logarithmic_error")
@register("msle")
def msle(p, y, mask=None, weights=None):
    lo = -1 + _EPS
    return _reduce(torch.square(torch.log1p(clip(p, lo))
                                - torch.log1p(clip(y, lo))), mask, weights)


@register("poisson")
def poisson(p, y, mask=None, weights=None):
    return _reduce(p - y * torch.log(clip(p, _EPS)), mask, weights)


def _l2_normalized(t):
    n = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    return t / clip(n, _EPS)


@register("cosine_proximity")
def cosine_proximity(p, y, mask=None, weights=None):
    """Minus the cosine of predictions and labels, per example (weights
    are not applied, as in the reference)."""
    per_example = -torch.sum(_l2_normalized(p) * _l2_normalized(y), dim=-1)
    if mask is None:
        return per_example.mean()
    m = _broadcast_mask(mask.to(per_example.device), per_example.shape) \
        .to(per_example.dtype)
    return (per_example * m).sum() / torch.clamp(m.sum(), min=1.0)


@register("wasserstein")
def wasserstein(p, y, mask=None, weights=None):
    return _reduce(p * y, mask, weights)


def center_loss(features: torch.Tensor, label_idx: torch.Tensor,
                centers: torch.Tensor, alpha: float = 0.05):
    """CenterLoss (CenterLossOutputLayer): ``(loss, new_centers)``. The
    loss pulls features toward their class centers; each center seen in
    the batch moves ``alpha`` of the way to its class mean."""
    num_classes = centers.shape[0]
    idx = label_idx.to(device=centers.device, dtype=torch.int64)
    picked = centers[idx]
    loss = 0.5 * torch.mean(torch.sum(torch.square(features - picked),
                                      dim=-1))
    onehot = torch.nn.functional.one_hot(idx, num_classes).to(features.dtype)
    hits = onehot.sum(dim=0)
    counts = torch.clamp_min(hits, 1.0)
    class_mean = (onehot.T @ features) / counts[:, None]
    seen = (hits > 0)[:, None]
    new_centers = torch.where(seen, centers + weak_scalar(
        alpha, centers.dtype) * (class_mean - centers), centers)
    return loss, new_centers
