"""Special layers — counterpart of ``Yolo2Output`` in
``deeplearning4j_tpu/nn/layers/special.py`` (``AutoEncoder``, ``VAE`` and
``Frozen`` are not ported yet: ROADMAP.md, Queue 1, "Special layers").

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
from dataclasses import dataclass
from typing import Sequence

import torch

from ...ops.activations import clip, sigmoid, softmax, weak_scalar
from ..api import Layer, register_layer


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
