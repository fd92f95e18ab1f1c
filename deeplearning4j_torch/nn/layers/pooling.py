"""Global pooling, Flatten and Reshape — counterpart of
``deeplearning4j_tpu/nn/layers/pooling.py``.

Reductions accumulate in f32 and round once to the input's dtype, as
``jnp.mean``/``jnp.sum`` do for bf16. A (B, T, F) input with a (B, T) mask
reduces over the unmasked steps only (MaskedReductionUtil); the output
carries no mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..api import Layer, Shape, register_layer


@register_layer
@dataclass(frozen=True)
class GlobalPooling(Layer):
    """GlobalPoolingLayer.java — reduce every axis but batch and
    features; mode max, avg, sum or pnorm."""

    mode: str = "avg"  # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[-1],)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        dt, p = x.dtype, self.pnorm
        if mask is not None and x.ndim == 3:
            m = mask.to(device=x.device, dtype=dt)[..., None]  # (B, T, 1)
            xm = x * m
            if self.mode == "max":
                y = torch.where(m > 0, x, torch.full_like(x, float("-inf"))
                                ).amax(dim=1)
            elif self.mode == "sum":
                y = xm.float().sum(dim=1).to(dt)
            elif self.mode == "avg":
                n = torch.clamp(m.float().sum(dim=1).to(dt), min=1.0)
                y = xm.float().sum(dim=1).to(dt) / n
            elif self.mode == "pnorm":
                y = (xm.abs() ** p).float().sum(dim=1).to(dt) ** (1.0 / p)
            else:
                raise ValueError(self.mode)
            return y, state, None
        axes = tuple(range(1, x.ndim - 1))
        if self.mode == "max":
            y = x.amax(dim=axes)
        elif self.mode == "sum":
            y = x.float().sum(dim=axes).to(dt)
        elif self.mode == "avg":
            y = x.float().mean(dim=axes).to(dt)
        elif self.mode == "pnorm":
            y = (x.abs() ** p).float().sum(dim=axes).to(dt) ** (1.0 / p)
        else:
            raise ValueError(self.mode)
        return y, state, None


@register_layer
@dataclass(frozen=True)
class Flatten(Layer):
    """CnnToFeedForwardPreProcessor equivalent: (B, ...) -> (B, prod)."""

    def output_shape(self, input_shape: Shape) -> Shape:
        n = 1
        for s in input_shape:
            n *= s
        return (n,)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return x.reshape(x.shape[0], -1), state, mask


@register_layer
@dataclass(frozen=True)
class Reshape(Layer):
    """ReshapeVertex as a layer: (B, ...) -> (B, *shape)."""

    shape: Sequence[int] = ()

    def output_shape(self, input_shape: Shape) -> Shape:
        return tuple(self.shape)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.shape)), state, mask
