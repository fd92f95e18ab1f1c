"""Special layers — counterpart of
``deeplearning4j_tpu/nn/layers/special.py``: ``AutoEncoder``, ``VAE``,
``Yolo2Output`` and ``Frozen``.

``Frozen`` runs its inner layer on detached params and with
``training=False``: no gradient reaches the frozen params (the trainer
leaves them out of autograd altogether and gives them the ``noop``
updater), a frozen BatchNorm normalizes with its running statistics and
does not update them, a frozen layer draws no dropout; the gradient of the
layer's input still flows, so a trainable layer below a frozen one trains.

``AutoEncoder`` and ``VAE`` are the reference's, with their layerwise
pretraining losses. The two packages draw different random streams, so
both losses also take their noise explicitly (``keep`` for the
AutoEncoder's corruption mask, ``eps`` of shape (samples, B, n_out) for the
VAE's reparameterization): from a generator, they draw it themselves.

``Yolo2Output`` writes the reference's ops in its order, so a bf16 forward
rounds where the reference's does: the anchors are rounded to x's dtype,
the box sizes clipped to [-10, 10] before ``exp``, the sigmoid and the
class softmax are the port's op-for-op versions, and the loss's constants
are weak scalars. The labels are not cast: against f32 labels each loss
term promotes to f32, as JAX's does, and ``Graph.score`` casts the total
to f32.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ...ops import activations, initializers, losses
from ...ops.activations import clip, sigmoid, softmax, weak_scalar
from ..api import Layer, Shape, layer_from_dict, register_layer


def _mlp_init(gen, sizes, weight_init, dtype, device):
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = initializers.init_param(gen, weight_init, (a, b),
                                                  dtype=dtype, device=device)
        params[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=device)
    return params


def _mlp_apply(params, x, act, n_layers):
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = act(x)
    return x


_LOG_2PI = math.log(2 * math.pi)


@register_layer
@dataclass(frozen=True)
class AutoEncoder(Layer):
    """AutoEncoder.java — a denoising autoencoder. ``apply`` is the hidden
    encoding; ``reconstruct`` decodes with the tied weights; and
    ``pretrain_loss`` is the loss of the reconstruction of the corrupted
    input against the clean one (``corruption_level`` of the inputs zeroed
    when a generator or a ``keep`` mask is given)."""

    n_out: int = 0
    activation: str = "sigmoid"
    corruption_level: float = 0.3
    loss: str = "mse"

    def output_shape(self, input_shape: Shape) -> Shape:
        return input_shape[:-1] + (self.n_out,)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n_in = input_shape[-1]
        w = initializers.init_param(gen, self.weight_init or "xavier",
                                    (n_in, self.n_out), dtype=dtype,
                                    device=device)
        return {"w": w,
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
                "vb": torch.zeros((n_in,), dtype=dtype, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        act = activations.get(self.activation)
        return act(x @ params["w"] + params["b"]), state, mask

    def reconstruct(self, params, h):
        act = activations.get(self.activation)
        return act(h @ params["w"].T + params["vb"])

    def corruption_mask(self, x, rng):
        """Which inputs survive the corruption: each with probability
        ``1 - corruption_level``, drawn from ``rng``."""
        return torch.rand(x.shape, generator=rng, device=x.device) \
            < 1.0 - self.corruption_level

    def pretrain_loss(self, params, x, rng=None, keep=None):
        corrupted = x
        if keep is None and rng is not None and self.corruption_level > 0:
            keep = self.corruption_mask(x, rng)
        if keep is not None:
            corrupted = torch.where(torch.as_tensor(keep, device=x.device)
                                    .bool(), x, torch.zeros_like(x))
        act = activations.get(self.activation)
        h = act(corrupted @ params["w"] + params["b"])
        return losses.get(self.loss)(self.reconstruct(params, h), x)


@register_layer
@dataclass(frozen=True)
class VAE(Layer):
    """VariationalAutoencoder — encoder MLP -> (mu, logvar) -> z -> decoder
    MLP, with a "gaussian" (diagonal) or "bernoulli" reconstruction.
    ``apply`` emits the latent mean; ``pretrain_loss`` is the negative
    ELBO averaged over ``num_samples`` draws of z and over the batch."""

    n_out: int = 0  # latent size
    encoder_sizes: Sequence[int] = (256,)
    decoder_sizes: Sequence[int] = (256,)
    activation: str = "relu"
    reconstruction: str = "gaussian"  # gaussian | bernoulli
    num_samples: int = 1

    def output_shape(self, input_shape: Shape) -> Shape:
        return (self.n_out,)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n_in = input_shape[-1]
        enc = [n_in, *self.encoder_sizes, 2 * self.n_out]
        out_mult = 2 if self.reconstruction == "gaussian" else 1
        dec = [self.n_out, *self.decoder_sizes, out_mult * n_in]
        scheme = self.weight_init or "xavier"
        return {"enc": _mlp_init(gen, enc, scheme, dtype, device),
                "dec": _mlp_init(gen, dec, scheme, dtype, device)}, {}

    def encode(self, params, x):
        act = activations.get(self.activation)
        out = _mlp_apply(params["enc"], x, act, len(self.encoder_sizes) + 1)
        mu, logvar = torch.chunk(out, 2, dim=-1)
        return mu, logvar

    def decode(self, params, z):
        act = activations.get(self.activation)
        return _mlp_apply(params["dec"], z, act, len(self.decoder_sizes) + 1)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        mu, _ = self.encode(params, x)
        return mu, state, mask

    def _noise(self, mu, rng, eps, n):
        if eps is not None:
            return torch.as_tensor(eps, dtype=mu.dtype, device=mu.device)
        return torch.randn((n,) + tuple(mu.shape), generator=rng,
                           dtype=mu.dtype, device=mu.device)

    def _log_px_z(self, out, x):
        """log p(x | z) of each example, from the decoder's output."""
        if self.reconstruction == "gaussian":
            rec_mu, rec_logvar = torch.chunk(out, 2, dim=-1)
            return -0.5 * torch.sum(
                rec_logvar + torch.square(x - rec_mu) / torch.exp(rec_logvar)
                + _LOG_2PI, dim=-1)
        p = torch.clamp(torch.sigmoid(out), 1e-7, 1 - 1e-7)
        return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p),
                         dim=-1)

    def pretrain_loss(self, params, x, rng=None, eps=None):
        mu, logvar = self.encode(params, x)
        kl = -0.5 * torch.sum(1 + logvar - torch.square(mu)
                              - torch.exp(logvar), dim=-1)
        eps = self._noise(mu, rng, eps, self.num_samples)
        std = torch.exp(0.5 * logvar)
        nll = torch.stack([-self._log_px_z(self.decode(params, mu + std * e), x)
                           for e in eps])
        return torch.mean(torch.mean(nll, dim=0) + kl)

    def generate(self, params, z):
        out = self.decode(params, z)
        if self.reconstruction == "gaussian":
            return torch.chunk(out, 2, dim=-1)[0]
        return torch.sigmoid(out)

    def reconstruction_log_probability(self, params, x, rng=None,
                                       num_samples: int = 16, eps=None):
        """Importance-sampling estimate of log p(x) per example
        (reconstructionLogProbability): logsumexp over samples of
        log p(x|z) + log p(z) - log q(z|x), less log S."""
        mu, logvar = self.encode(params, x)
        std = torch.exp(0.5 * logvar)
        eps = self._noise(mu, rng, eps, num_samples)
        log_w = []
        for e in eps:
            z = mu + std * e
            log_pz = -0.5 * torch.sum(torch.square(z) + _LOG_2PI, dim=-1)
            log_qz_x = -0.5 * torch.sum(logvar + torch.square(e) + _LOG_2PI,
                                        dim=-1)
            log_w.append(self._log_px_z(self.decode(params, z), x) + log_pz
                         - log_qz_x)
        return torch.logsumexp(torch.stack(log_w), dim=0) - math.log(len(eps))

    def reconstruction_probability(self, params, x, rng=None,
                                   num_samples: int = 16, eps=None):
        return torch.exp(self.reconstruction_log_probability(
            params, x, rng, num_samples, eps))


@functools.lru_cache(maxsize=None)
def _anchor_tensor(anchors, dtype: torch.dtype, device: torch.device):
    """The anchors as an (A, 2) tensor of ``dtype`` on ``device``, made once
    (a host-to-device copy cannot be recorded into a CUDA graph; the
    captured step's warm-up makes it first), and never as an inference
    tensor, which autograd could not use after a served forward."""
    with torch.inference_mode(False):
        return torch.tensor(anchors, dtype=torch.float64).to(dtype).to(device)


@register_layer
@dataclass(frozen=True)
class Yolo2Output(Layer):
    """Yolo2OutputLayer — the YOLOv2 detection head and loss over
    (B, H, W, A*(5+C)). ``apply`` decodes each anchor's box: sigmoid x, y;
    ``exp`` of the clipped w, h times the anchor; sigmoid confidence;
    softmax over the classes. ``score`` takes labels (B, H, W, A, 5+C) (or
    flattened to (B, H, W, A*(5+C))) of [x, y, w, h, obj, class one-hot]
    in grid units and sums the position, size (square roots), confidence
    (``lambda_noobj`` where no object) and class terms, the first two
    weighted by ``lambda_coord``, over the batch size."""

    _HAS_PARAMS = False

    anchors: Sequence[Sequence[float]] = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        B, H, W, _ = x.shape
        A = len(self.anchors)
        y = x.reshape(B, H, W, A, -1)
        anchors = _anchor_tensor(tuple(map(tuple, self.anchors)), x.dtype,
                                 x.device)
        xy = sigmoid(y[..., 0:2])
        wh = torch.exp(clip(y[..., 2:4], -10.0, 10.0)) * anchors
        conf = sigmoid(y[..., 4:5])
        cls = softmax(y[..., 5:], dim=-1)
        out = torch.cat([xy, wh, conf, cls], dim=-1)
        return out.reshape(B, H, W, -1), state, mask

    def score(self, params, state, x, labels, *, mask=None):
        B, H, W, _ = x.shape
        A = len(self.anchors)
        pred = self.apply(params, state, x)[0].reshape(B, H, W, A, -1)
        lab = labels.to(x.device).reshape(B, H, W, A, -1)
        obj = lab[..., 4:5]
        eps = weak_scalar(1e-8, x.dtype)
        pos = torch.sum(obj * torch.square(pred[..., 0:2] - lab[..., 0:2]))
        size = torch.sum(obj * torch.square(
            torch.sqrt(pred[..., 2:4] + eps)
            - torch.sqrt(torch.abs(lab[..., 2:4]) + weak_scalar(
                1e-8, lab.dtype))))
        conf = pred[..., 4:5]
        conf_loss = (torch.sum(obj * torch.square(conf - 1.0))
                     + self.lambda_noobj * torch.sum(
                         (1 - obj) * torch.square(conf)))
        cls = torch.sum(obj * torch.square(pred[..., 5:] - lab[..., 5:]))
        return (self.lambda_coord * (pos + size) + conf_loss + cls) / B


@register_layer
@dataclass(frozen=True)
class Frozen(Layer):
    """FrozenLayer.java — the inner layer (its ``@type`` JSON in ``inner``)
    on detached params, in inference mode."""

    inner: Optional[dict] = None

    @functools.cached_property
    def _layer(self) -> Layer:
        # parsed once (cached_property writes the instance dict directly,
        # which a frozen dataclass allows)
        return layer_from_dict(self.inner)

    def _sub(self) -> Layer:
        return self._layer

    def has_params(self):
        return self._sub().has_params()

    def output_shape(self, input_shape: Shape) -> Shape:
        return self._sub().output_shape(input_shape)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return self._sub().init(gen, input_shape, dtype, device)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        frozen = {k: _detach(v) for k, v in params.items()}
        return self._sub().apply(frozen, state, x, training=False, rng=rng,
                                 mask=mask)


def _detach(t):
    if isinstance(t, dict):
        return {k: _detach(v) for k, v in t.items()}
    return t.detach()
