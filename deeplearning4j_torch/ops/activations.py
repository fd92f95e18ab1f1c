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

``sigmoid`` and ``tanh`` (the recurrent layers' gate and cell activations)
carry JAX's gradients op for op: ``g * (y * (1 - y))`` for the sigmoid and
``t + t * y`` with ``t = g * (1 - y)`` for tanh, each product rounded in
the gradient's dtype (torch's fused backwards round once and differ by a
bf16 ulp on about a fifth of the elements). XLA expands ``logistic`` into
negate, exp, add 1 and divide, rounding after each: in bf16 the port does
the same and is bit-equal to ``jax.nn.sigmoid``; in f32 the two packages'
``exp`` differ by an ulp, and ``torch.sigmoid`` lands closer to JAX than
the expansion (1 ulp on 90 of 20,001 points in [-8, 8], against 907), so
f32 takes it.
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


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.dtype in (torch.bfloat16, torch.float16):
            # one rounding for 1 / u (torch's ``1.0 / u`` is a reciprocal
            # then a product: the same bits, one more launch)
            y = torch.reciprocal(1.0 + torch.exp(-x))
        else:
            y = torch.sigmoid(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        t = g * (1.0 - y)
        return t + t * y


def sigmoid(x):
    """``jax.nn.sigmoid`` with its rounding and its gradient."""
    return _Sigmoid.apply(x)


def tanh(x):
    """``jnp.tanh`` with its gradient's rounding."""
    return _Tanh.apply(x)


def hard_sigmoid(x):
    """``jax.nn.hard_sigmoid``: relu6(x + 3) / 6, with relu6's zero
    gradient at 0 and 6 and the division as XLA rewrites it (times 1/6)."""
    u = x + 3.0
    inside = (u > 0) & (u < 6)
    return torch.where(inside, u, torch.clamp(u, 0.0, 6.0).detach()) * (1 / 6)


register("identity")(lambda x: x)
register("relu")(torch.relu)
register("softmax")(softmax)
register("gelu")(gelu)
register("sigmoid")(sigmoid)
register("tanh")(tanh)
register("hardsigmoid")(hard_sigmoid)
