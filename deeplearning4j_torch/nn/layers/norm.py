"""Normalization — counterpart of ``deeplearning4j_tpu/nn/layers/norm.py``:
``BatchNorm``, ``LRN``, ``LayerNorm`` and ``RMSNorm``. Each writes the
reference's ops in its order, so that in bf16 each intermediate rounds
where the reference's does; an ``rsqrt`` runs in f32 and rounds once, as
XLA's does (torch's CPU bf16 ``rsqrt`` is an ulp off on some inputs)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...ops import activations
from ...ops.activations import weak_scalar
from ...ops.batch_norm import batch_norm_train
from ..api import Layer, register_layer


@register_layer
@dataclass(frozen=True)
class BatchNorm(Layer):
    """BatchNormalization.java — normalizes over every axis but the last.

    Running mean and var live in ``state`` (f32, whatever the compute
    dtype); training-mode ``apply`` returns them EMA-updated with ``decay``
    and the caller threads them, as in the reference. Training mode runs
    ``ops.batch_norm.batch_norm_train`` on the (M, C) rows (single-pass f32
    statistics; the backward is the K4a/K4b kernels); inference mode is
    ``y = x·a + b`` from the running statistics under plain autograd. Both
    fold (mean, var, γ, β) into a per-channel f32 affine cast to x's dtype,
    as the reference does."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False  # fixed gamma = 1, beta = 0
    activation: str = "identity"

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n = input_shape[-1]
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.ones((n,), dtype=dtype, device=device),
                      "beta": torch.zeros((n,), dtype=dtype, device=device)}
        state = {"mean": torch.zeros((n,), dtype=dtype, device=device),
                 "var": torch.ones((n,), dtype=dtype, device=device)}
        return params, state

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        gamma = None if self.lock_gamma_beta else params["gamma"]
        beta = None if self.lock_gamma_beta else params["beta"]
        if training:
            C = x.shape[-1]
            y, mean, var = batch_norm_train(x.contiguous().view(-1, C), gamma,
                                            beta, self.eps)
            y = y.view(x.shape)
            sdt = state["mean"].dtype
            new_state = {
                "mean": self.decay * state["mean"]
                + (1 - self.decay) * mean.to(sdt),
                "var": self.decay * state["var"]
                + (1 - self.decay) * var.to(sdt)}
        else:
            inv = torch.rsqrt(state["var"].float() + self.eps)
            mean = state["mean"].float()
            if gamma is None:
                a, b = inv, -mean * inv
            else:
                a = inv * gamma.float()
                b = beta.float() - mean * a
            y = x * a.to(x.dtype) + b.to(x.dtype)
            new_state = state
        return activations.get(self.activation)(y), new_state, mask


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """Normalize over the last axis with the biased variance:
    (x - mean) * rsqrt(var + eps) * gamma + beta, as the reference writes
    it: mean and var accumulated in f32 and stored in x's dtype, then one
    rounding per op (``F.layer_norm`` would round once). The rsqrt runs in
    f32 and rounds once, as XLA's does: torch's CPU bf16 rsqrt is off by
    an ulp on some inputs."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(x.dtype)
    inv = torch.rsqrt((var + weak_scalar(eps, x.dtype)).float()).to(x.dtype)
    y = (x - mean) * inv * gamma
    return y if beta is None else y + beta


@register_layer
@dataclass(frozen=True)
class LayerNorm(Layer):
    """Per-example normalization over the feature axis."""

    eps: float = 1e-6
    use_bias: bool = True

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n = input_shape[-1]
        params = {"gamma": torch.ones((n,), dtype=dtype, device=device)}
        if self.use_bias:
            params["beta"] = torch.zeros((n,), dtype=dtype, device=device)
        return params, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return (layer_norm(x, params["gamma"], params.get("beta"), self.eps),
                state, mask)


@register_layer
@dataclass(frozen=True)
class LRN(Layer):
    """LocalResponseNormalization.java — cross-channel:
    ``x / (k + alpha/n * sum_{window} x_j^2) ** beta`` over a window of
    ``n`` channels centred on each (zero-padded at the edges). The window
    sum is taken in x's dtype, one channel after another in window order,
    as the reference's ``reduce_window`` adds."""

    _HAS_PARAMS = False

    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        half = self.n // 2
        sq = F.pad(x * x, (half, self.n - 1 - half))
        C = x.shape[-1]
        ssum = sq[..., 0:C]
        for j in range(1, self.n):
            ssum = ssum + sq[..., j: j + C]
        dt = x.dtype
        base = weak_scalar(self.k, dt) + weak_scalar(self.alpha / self.n,
                                                     dt) * ssum
        return x / base ** weak_scalar(self.beta, dt), state, mask


@register_layer
@dataclass(frozen=True)
class RMSNorm(Layer):
    """RMS normalization: ``x * rsqrt(mean(x^2) + eps) * gamma``, the mean
    accumulated in f32 and stored in x's dtype."""

    eps: float = 1e-6

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return {"gamma": torch.ones((input_shape[-1],), dtype=dtype,
                                    device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        ms = (x * x).float().mean(dim=-1, keepdim=True).to(x.dtype)
        inv = torch.rsqrt((ms + weak_scalar(self.eps, x.dtype)).float()
                          ).to(x.dtype)
        return x * inv * params["gamma"], state, mask
