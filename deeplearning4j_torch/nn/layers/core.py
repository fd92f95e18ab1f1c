"""Core layers — counterpart of ``deeplearning4j_tpu/nn/layers/core.py``
(Dense, ActivationLayer, EmbeddingSequence, Output, RnnOutput). Dense weights are (in, out),
as in the reference, so params cross between the packages unchanged.
Output layers score with the reference's fusion: softmax + MCXENT becomes
``mcxent_logits`` on the preactivation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops import activations, initializers, losses
from ..api import Layer, Shape, no_training_dropout, register_layer


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
        no_training_dropout(self, self.dropout, training)
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


class _LossMixin:
    """Shared scoring for output layers (DL4J BaseOutputLayer.computeScore).
    Softmax + MCXENT (or NLL) is fused into the stable ``mcxent_logits`` on
    the preactivation; ``apply`` still emits probabilities. Sigmoid + XENT
    (``xent_logits``) and the other losses are not ported yet."""

    def _loss_fn_and_preact(self):
        act = getattr(self, "activation", "identity")
        loss = str(getattr(self, "loss", "mse")).lower()
        if act == "softmax" and loss in ("mcxent", "negativeloglikelihood"):
            return losses.get("mcxent_logits"), True
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
        no_training_dropout(self, self.dropout, training)
        return (activations.get(self.activation)(self.preactivation(params, x)),
                state, mask)

    def score(self, params, state, x, labels, *, mask=None):
        return self.score_from_preactivation(self.preactivation(params, x),
                                             labels, mask)


@register_layer
@dataclass(frozen=True)
class RnnOutput(Output):
    """Per-timestep Output over (B, T, F), with time masking in score."""
