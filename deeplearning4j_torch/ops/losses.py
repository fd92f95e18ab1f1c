"""Loss functions — counterpart of ``deeplearning4j_tpu/ops/losses.py``.

Each loss is ``fn(predictions, labels, mask=None, weights=None) -> scalar``:
the mean over examples (and timesteps) of the sum over output units, the
reference's ``computeScore(average=True)`` convention. This slice carries
the cross-entropy family its language model trains with: ``mcxent`` (alias
``negativeloglikelihood``) on probabilities and the fused
``mcxent_logits`` (alias ``softmax_cross_entropy_logits``). Integer labels
one rank below the predictions are class indices: the target log-prob is
gathered, and no (B, T, V) one-hot is ever built.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

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
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(_REGISTRY)} "
                         f"(the other losses of the JAX package are not ported "
                         f"yet: ROADMAP.md, Queue 1)")
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
        return torch.tensor(float(math.prod(pe_shape)), dtype=torch.float32)
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
