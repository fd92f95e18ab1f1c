"""Activation functions by canonical name — counterpart of
``deeplearning4j_tpu/ops/activations.py``.

Configs name activations as strings, so the registry keys are the
reference's; the port carries the ones its layers use so far. ``gelu`` is the
tanh approximation, which is what ``jax.nn.gelu`` computes by default
(torch's default is the erf form).

``gelu`` and ``softmax`` are written op for op as JAX writes them, so that
in a bf16 forward each intermediate is rounded to bf16 where the
reference's is; a fused op (``F.gelu``, ``F.softmax``) rounds once at the
end and lands a bf16 ulp away on about half the elements.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import torch

_REGISTRY: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get(name_or_fn) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by name (case-insensitive) or pass a callable."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name_or_fn}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` as a JAX op on a ``dtype`` array sees a Python scalar: rounded
    to ``dtype`` first (torch would keep it at f32 in a bf16 op)."""
    return float(torch.tensor(c, dtype=dtype))


def softmax(x, dim: int = -1):
    """``jax.nn.softmax``: max, shift, exp, sum (accumulated in f32), divide,
    each result in x's dtype."""
    u = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return u / u.sum(dim=dim, keepdim=True)


def gelu(x):
    """``jax.nn.gelu`` (tanh form): 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715
    x^3))) x, with x^3 as x*x*x and the constants in x's dtype."""
    c = weak_scalar(0.044715, x.dtype)
    s = weak_scalar(math.sqrt(2 / math.pi), x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(s * (x + c * (x * x * x)))))


register("identity")(lambda x: x)
register("relu")(torch.relu)
register("softmax")(softmax)
register("gelu")(gelu)
