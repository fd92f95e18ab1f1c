"""Core layers — counterpart of ``deeplearning4j_tpu/nn/layers/core.py``,
every layer of it: Dense, ActivationLayer, DropoutLayer, GaussianNoise,
GaussianDropout, AlphaDropout, Embedding, EmbeddingSequence,
ElementWiseMultiplication, PReLU, Output, LossLayer, RnnOutput,
CnnLossLayer, RnnLossLayer and CenterLossOutput. Dense weights are
(in, out), as in the reference, so params cross between the packages
unchanged. Dense and Output apply their ``dropout`` to their input in
training; the noise layers draw from the ``rng`` generator in training and
are the identity otherwise.
Output layers score with the reference's fusion: softmax + MCXENT becomes
``mcxent_logits`` on the preactivation, sigmoid + XENT ``xent_logits``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops import activations, initializers, losses, regularization
from ...ops.activations import weak_scalar
from ..api import Layer, Shape, apply_input_dropout, register_layer


def _dense_params(layer, gen, n_in, n_out, use_bias, dtype, device):
    params = {"w": initializers.init_param(
        gen, layer.weight_init or "xavier", (n_in, n_out), dtype=dtype,
        device=device)}
    if use_bias:
        params["b"] = torch.zeros((n_out,), dtype=dtype, device=device)
    return params


@register_layer
@dataclass(frozen=True)
class Dense(Layer):
    """Fully-connected layer: y = act(x @ W + b)."""

    n_out: int = 0
    activation: str = "identity"
    use_bias: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        return input_shape[:-1] + (self.n_out,)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return _dense_params(self, gen, input_shape[-1], self.n_out,
                             self.use_bias, dtype, device), {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        x = apply_input_dropout(self, x, rng, training)
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


@register_layer
@dataclass(frozen=True)
class ActivationLayer(Layer):
    """A standalone activation (ActivationLayer.java)."""

    activation: str = "relu"

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return activations.get(self.activation)(x), state, mask


def _needs_rng(layer, rng, training: bool) -> None:
    if training and rng is None:
        raise ValueError(f"{type(layer).__name__} needs rng in training mode")


def _check_rate(layer_name: str, rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{layer_name} rate must be in [0, 1), got {rate}")


@register_layer
@dataclass(frozen=True)
class DropoutLayer(Layer):
    """A standalone dropout layer (DropoutLayer.java); ``rate`` is the
    drop probability."""

    rate: float = 0.5

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        _needs_rng(self, rng, training)
        return regularization.dropout(rng, x, self.rate, training), state, mask


@register_layer
@dataclass(frozen=True)
class GaussianNoise(Layer):
    """Additive zero-mean Gaussian noise in training
    (conf/dropout/GaussianNoise.java)."""

    stddev: float = 0.1

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        if training:
            _needs_rng(self, rng, training)
            x = regularization.gaussian_noise(rng, x, self.stddev)
        return x, state, mask


@register_layer
@dataclass(frozen=True)
class GaussianDropout(Layer):
    """Multiplicative 1-mean Gaussian noise of stddev
    sqrt(rate / (1 - rate)) (conf/dropout/GaussianDropout.java)."""

    rate: float = 0.5

    def __post_init__(self):
        _check_rate("GaussianDropout", self.rate)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        if training and self.rate > 0.0:
            _needs_rng(self, rng, training)
            std = weak_scalar((self.rate / (1.0 - self.rate)) ** 0.5, x.dtype)
            x = x * (1.0 + std * regularization.normal_like(rng, x))
        return x, state, mask


@register_layer
@dataclass(frozen=True)
class AlphaDropout(Layer):
    """SELU-preserving dropout (conf/dropout/AlphaDropout.java): dropped
    units take alpha' and the output is rescaled affinely, with the
    reference layer's constants."""

    rate: float = 0.5

    def __post_init__(self):
        _check_rate("AlphaDropout", self.rate)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        if training and self.rate > 0.0:
            _needs_rng(self, rng, training)
            alpha_p = -1.7580993408473766  # -alpha*lambda of SELU
            q = 1.0 - self.rate
            a = float((q + alpha_p ** 2 * q * self.rate) ** -0.5)
            b = float(-a * alpha_p * self.rate)
            kept = regularization.uniform(rng, x.shape, x.device) < q
            dt = x.dtype
            x = weak_scalar(a, dt) * torch.where(kept, x, torch.full(
                (), alpha_p, dtype=dt, device=x.device)) + weak_scalar(b, dt)
        return x, state, mask


@register_layer
@dataclass(frozen=True)
class EmbeddingSequence(Layer):
    """(B, T) int ids -> (B, T, n_out). ``mask_zero=True`` emits the
    (B, T) padding mask (ids != 0) downstream."""

    n_in: int = 0
    n_out: int = 0
    mask_zero: bool = False

    def output_shape(self, input_shape: Shape) -> Shape:
        return input_shape + (self.n_out,)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return {"w": initializers.init_param(
            gen, self.weight_init or "xavier", (self.n_in, self.n_out),
            dtype=dtype, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        ids = x.long()
        if self.mask_zero and mask is None:
            mask = (ids != 0).float()
        return params["w"][ids], state, mask


@register_layer
@dataclass(frozen=True)
class Embedding(Layer):
    """EmbeddingLayer.java: (B,) or (B, 1) integer ids -> (B, n_out).
    ``one_hot_matmul`` takes the lookup as a one-hot product, as the
    reference does for tiny vocabularies."""

    n_in: int = 0  # vocab size
    n_out: int = 0
    use_bias: bool = False
    activation: str = "identity"
    one_hot_matmul: bool = False

    def output_shape(self, input_shape: Shape) -> Shape:
        return (self.n_out,)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return _dense_params(self, gen, self.n_in, self.n_out, self.use_bias,
                             dtype, device), {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        ids = x.long()
        if ids.ndim >= 2 and ids.shape[-1] == 1:
            ids = ids[..., 0]
        w = params["w"]
        if self.one_hot_matmul:
            y = torch.nn.functional.one_hot(ids, self.n_in).to(w.dtype) @ w
        else:
            y = w[ids]
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


@register_layer
@dataclass(frozen=True)
class ElementWiseMultiplication(Layer):
    """ElementWiseMultiplicationLayer: y = act(x * w + b), a learned
    per-feature scale and shift."""

    activation: str = "identity"

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n = input_shape[-1]
        return {"w": torch.ones((n,), dtype=dtype, device=device),
                "b": torch.zeros((n,), dtype=dtype, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        y = x * params["w"] + params["b"]
        return activations.get(self.activation)(y), state, mask


@register_layer
@dataclass(frozen=True)
class PReLU(Layer):
    """PReLULayer: ReLU with a learned negative slope per feature,
    ``where(x >= 0, x, x * alpha)``."""

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return {"alpha": torch.zeros((input_shape[-1],), dtype=dtype,
                                     device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return torch.where(x >= 0, x, x * params["alpha"]), state, mask


class _LossMixin:
    """Shared scoring for output layers (DL4J BaseOutputLayer.computeScore).
    Softmax + MCXENT (or NLL) is fused into the stable ``mcxent_logits`` on
    the preactivation, sigmoid + XENT into ``xent_logits``; ``apply`` still
    emits the activation."""

    def _loss_fn_and_preact(self):
        act = getattr(self, "activation", "identity")
        loss = str(getattr(self, "loss", "mse")).lower()
        if act == "softmax" and loss in ("mcxent", "negativeloglikelihood"):
            return losses.get("mcxent_logits"), True
        if act == "sigmoid" and loss == "xent":
            return losses.get("xent_logits"), True
        return losses.get(loss), False

    def score_from_preactivation(self, preact, labels, mask=None):
        fn, fused = self._loss_fn_and_preact()
        if fused:
            return fn(preact, labels, mask=mask)
        act = activations.get(getattr(self, "activation", "identity"))
        return fn(act(preact), labels, mask=mask)


@register_layer
@dataclass(frozen=True)
class Output(Layer, _LossMixin):
    """Dense + activation; ``score()`` computes the training loss named by
    ``loss``."""

    n_out: int = 0
    activation: str = "softmax"
    loss: str = "mcxent"
    use_bias: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        return input_shape[:-1] + (self.n_out,)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return _dense_params(self, gen, input_shape[-1], self.n_out,
                             self.use_bias, dtype, device), {}

    def preactivation(self, params, x):
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        x = apply_input_dropout(self, x, rng, training)
        return (activations.get(self.activation)(self.preactivation(params, x)),
                state, mask)

    def score(self, params, state, x, labels, *, mask=None):
        return self.score_from_preactivation(self.preactivation(params, x),
                                             labels, mask)


@register_layer
@dataclass(frozen=True)
class RnnOutput(Output):
    """Per-timestep Output over (B, T, F), with time masking in score."""


@register_layer
@dataclass(frozen=True)
class LossLayer(Layer, _LossMixin):
    """LossLayer.java: a loss without params; its input is already n_out
    wide."""

    activation: str = "identity"
    loss: str = "mse"

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return activations.get(self.activation)(x), state, mask

    def score(self, params, state, x, labels, *, mask=None):
        return self.score_from_preactivation(x, labels, mask)


@register_layer
@dataclass(frozen=True)
class CnnLossLayer(LossLayer):
    """CnnLossLayer.java: a per-pixel loss over (B, H, W, C)."""


@register_layer
@dataclass(frozen=True)
class RnnLossLayer(LossLayer):
    """RnnLossLayer.java: a per-timestep loss over (B, T, F), with time
    masking."""


@register_layer
@dataclass(frozen=True)
class CenterLossOutput(Output):
    """CenterLossOutputLayer.java: softmax cross-entropy plus ``lambda_``
    times the center loss of the input features; the class centers live in
    ``state`` and move with :meth:`update_centers`."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        params, _ = super().init(gen, input_shape, dtype, device)
        return params, {"centers": torch.zeros(
            (self.n_out, input_shape[-1]), dtype=dtype, device=device)}

    def score(self, params, state, x, labels, *, mask=None):
        ce = self.score_from_preactivation(self.preactivation(params, x),
                                           labels, mask)
        label_idx = torch.argmax(labels, dim=-1)
        cl, _ = losses.center_loss(x, label_idx, state["centers"], self.alpha)
        return ce + self.lambda_ * cl

    def update_centers(self, state, x, labels):
        label_idx = torch.argmax(labels, dim=-1)
        _, centers = losses.center_loss(x, label_idx, state["centers"],
                                        self.alpha)
        return {**state, "centers": centers}
