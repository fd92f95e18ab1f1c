"""Activation functions by canonical name — counterpart of
``deeplearning4j_tpu/ops/activations.py``.

Configs name activations as strings, so the registry keys are the
reference's, every one of them. ``gelu`` is the
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

The others follow JAX's definitions op for op, each constant a weak
scalar rounded to x's dtype (:func:`weak_scalar`), and JAX's gradients
where they are defined by hand: ``leakyrelu`` (and ``rrelu``, its mean
slope) is ``where(x >= 0, x, αx)``, so its gradient at exactly 0 is 1
(``F.leaky_relu``'s is α); ``relu6`` has a zero gradient at 0 and 6;
``softplus`` is ``logaddexp(x, 0)``, ``max(x, 0) + log1p(exp(-|x|))``,
with its gradient ``exp(x - y)``; ``hardtanh`` and ``rectified_tanh``
are ``maximum``/``minimum`` chains, whose gradient at a tie is split in
half in both packages.
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


def clip(x, lo=None, hi=None):
    """``jnp.clip``: ``maximum`` with ``lo``, then ``minimum`` with ``hi``,
    each bound a 0-d tensor in x's dtype (made by a fill, so a CUDA graph
    can record it); a tie splits the gradient in half, as JAX's does
    (``torch.clamp`` passes it whole)."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                        device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype,
                                        device=x.device))
    return x


def leaky_relu(x, alpha: float = 0.01):
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, alpha * x)``; the gradient
    at 0 is 1."""
    return torch.where(x >= 0, x, weak_scalar(alpha, x.dtype) * x)


def relu6(x):
    """``jax.nn.relu6``, with its zero gradient at 0 and at 6."""
    inside = (x > 0) & (x < 6)
    return torch.where(inside, x, torch.clamp(x, 0.0, 6.0).detach())


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        y = torch.where(torch.isnan(x), x, y)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        xs = torch.where(torch.isinf(x), zero, x)
        ys = torch.where(torch.isinf(y), zero, y)
        return g * torch.exp(xs - ys)


def softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, with logaddexp's
    gradient ``exp(x - y)`` (infinities replaced by 0)."""
    return _Softplus.apply(x)


def softsign(x):
    """``jax.nn.soft_sign``: x / (|x| + 1)."""
    return x / (torch.abs(x) + 1.0)


def elu(x, alpha: float = 1.0):
    """``jax.nn.elu``: ``where(x > 0, x, alpha * expm1(where(x > 0, 0,
    x)))``."""
    pos = x > 0
    neg = torch.expm1(torch.where(pos, torch.zeros_like(x), x))
    return torch.where(pos, x, weak_scalar(alpha, x.dtype) * neg)


def selu(x):
    """``jax.nn.selu``: scale * elu(x, alpha)."""
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    return weak_scalar(scale, x.dtype) * elu(x, alpha)


def silu(x):
    """``jax.nn.silu`` (``swish``): x * sigmoid(x)."""
    return x * sigmoid(x)


def mish(x):
    """The reference's mish: x * tanh(softplus(x))."""
    return x * tanh(softplus(x))


def hardtanh(x):
    """The reference's ``jnp.clip(x, -1, 1)``: maximum, then minimum."""
    return clip(x, -1.0, 1.0)


def rational_tanh(x):
    """The reference's rational_tanh: 1.7159 * tanh(2/3 * x)."""
    return weak_scalar(1.7159, x.dtype) * tanh(
        weak_scalar(2.0 / 3.0, x.dtype) * x)


def rectified_tanh(x):
    """The reference's rectified_tanh: maximum(0, tanh(x))."""
    return clip(tanh(x), 0.0)


def rrelu(x, lower: float = 1.0 / 8, upper: float = 1.0 / 3):
    """Deterministic RReLU, as the reference's: leaky with the mean slope
    of the range."""
    return leaky_relu(x, (lower + upper) / 2.0)


def thresholded_relu(x, theta: float = 1.0):
    """``where(x > theta, x, 0)``."""
    return torch.where(x > theta, x, torch.zeros_like(x))


def names():
    return sorted(_REGISTRY)


def softmax_stable(x, axis: int = -1):
    """The loss layers' numerically stable softmax (shifted by the max):
    :func:`softmax` along ``axis``."""
    return softmax(x, dim=axis)


register("identity")(lambda x: x)
register("linear")(lambda x: x)
register("relu")(torch.relu)
register("relu6")(relu6)
register("sigmoid")(sigmoid)
register("tanh")(tanh)
register("softmax")(softmax)
register("softplus")(softplus)
register("softsign")(softsign)
register("elu")(elu)
register("selu")(selu)
register("gelu")(gelu)
register("swish")(silu)
register("silu")(silu)
register("mish")(mish)
register("hardsigmoid")(hard_sigmoid)
register("hardtanh")(hardtanh)
register("cube")(lambda x: x * x * x)
register("rational_tanh")(rational_tanh)
register("rectified_tanh")(rectified_tanh)
register("sin")(torch.sin)
register("exp")(torch.exp)
register("leakyrelu")(leaky_relu)
register("rrelu")(rrelu)
register("thresholdedrelu")(thresholded_relu)
