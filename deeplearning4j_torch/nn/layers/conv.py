"""Convolution and pooling layers — counterpart of ``Conv2D`` and
``Subsampling2D`` in ``deeplearning4j_tpu/nn/layers/conv.py``.

Activations are NHWC and conv weights HWIO ``(kh, kw, c_in, c_out)`` at
every public function, as in the reference, so params and inputs cross
between the packages unchanged. Inside, a contiguous NHWC tensor viewed as
NCHW (``x.permute(0, 3, 1, 2)``) is a channels_last tensor without a copy,
and the convolution runs through cuDNN (``F.conv2d``) on that view; its
channels_last output viewed back as NHWC is contiguous again. The
reference computes convolutions outside any Pallas kernel (XLA), so the
library convolution is the counterpart, not a port of a kernel.

``"same"`` padding is XLA's: the total padding of a dimension is
``max((out - 1) * stride + effective_kernel - in, 0)``, split with the
smaller half first, so a 7x7/2 conv on 224 pads (2, 3) and a 3x3/2 pool on
112 pads (0, 1). ``F.conv2d`` and ``F.max_pool2d`` pad symmetrically, so an
uneven split is padded explicitly first (zeros for a conv, -inf for max
pooling). The reference's space-to-depth rewrite of the 7x7/2 stem conv
(``conv.py:107-141``) is a pure reparametrization of the same function;
the port runs the plain strided conv, and the params keep HWIO
``(7, 7, 3, 64)``.

Not ported yet (ROADMAP.md, Queue 1, "The rest of
``nn/layers/{conv,norm,pooling}``"): ``Subsampling2D`` pnorm and
the other layers of the reference's module (Conv1D, Deconv2D,
DepthwiseConv2D, SeparableConv2D, Upsampling, ZeroPadding, Cropping,
SpaceToBatch, SpaceToDepth).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ...ops import activations, initializers
from ..api import Layer, Shape, no_training_dropout, register_layer

IntPair = Union[int, Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(int(x) for x in v)  # type: ignore


def _out_size(size: int, k: int, s: int, d: int, padding, axis: int) -> int:
    ek = (k - 1) * d + 1
    if padding == "same":
        return -(-size // s)
    if padding == "valid":
        return (size - ek) // s + 1
    p = _pair(padding)[axis]
    return (size + 2 * p - ek) // s + 1


def _pads(in_hw, kernel, stride, dilation, padding) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) padding of H and W, the reference's convention."""
    if padding == "valid":
        return ((0, 0), (0, 0))
    if padding != "same":
        p = _pair(padding)
        return ((p[0], p[0]), (p[1], p[1]))
    out = []
    for size, k, s, d in zip(in_hw, kernel, stride, dilation):
        ek = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + ek - size, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """A contiguous NHWC tensor as a channels_last NCHW view."""
    return x.contiguous().permute(0, 3, 1, 2)


def _to_nhwc(y: torch.Tensor) -> torch.Tensor:
    """An NCHW result as contiguous NHWC (a view when it is
    channels_last)."""
    return y.permute(0, 2, 3, 1).contiguous()


def _check_padding(layer, padding) -> None:
    if isinstance(padding, str) and padding not in ("same", "valid"):
        raise ValueError(f"{type(layer).__name__}: padding must be 'same', "
                         f"'valid' or (ph, pw), got {padding!r}")


@register_layer
@dataclass(frozen=True)
class Conv2D(Layer):
    """ConvolutionLayer.java — 2D conv over NHWC with HWIO weights."""

    n_out: int = 0
    kernel: IntPair = (3, 3)
    stride: IntPair = (1, 1)
    padding: Union[str, IntPair] = "same"  # "same" | "valid" | (ph, pw)
    dilation: IntPair = (1, 1)
    activation: str = "identity"
    use_bias: bool = True
    groups: int = 1

    def output_shape(self, input_shape: Shape) -> Shape:
        _check_padding(self, self.padding)
        h, w, _ = input_shape
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        dh, dw = _pair(self.dilation)
        return (_out_size(h, kh, sh, dh, self.padding, 0),
                _out_size(w, kw, sw, dw, self.padding, 1), self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel)
        params = {"w": initializers.init_param(
            gen, self.weight_init or "relu",
            (kh, kw, input_shape[-1] // self.groups, self.n_out), kind="conv",
            dtype=dtype, device=device)}
        if self.use_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return params, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        no_training_dropout(self, self.dropout, training)
        kernel, stride = _pair(self.kernel), _pair(self.stride)
        dilation = _pair(self.dilation)
        (ph_lo, ph_hi), (pw_lo, pw_hi) = _pads(x.shape[1:3], kernel, stride,
                                               dilation, self.padding)
        if ph_lo != ph_hi or pw_lo != pw_hi:
            x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
            pad = (0, 0)
        else:
            pad = (ph_lo, pw_lo)
        # HWIO -> OHWI contiguous -> OIHW channels_last view
        w = params["w"].permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        y = _to_nhwc(F.conv2d(_to_nchw(x), w, None, stride, pad, dilation,
                              self.groups))
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


@register_layer
@dataclass(frozen=True)
class Subsampling2D(Layer):
    """SubsamplingLayer.java — max, avg and sum pooling over NHWC. avg
    divides the window sum by kh*kw, padding included, as the reference's
    ``reduce_window`` does; the sum is taken in x's dtype, one window
    element after another (only max pooling is on ResNet-50's path)."""

    kernel: IntPair = (2, 2)
    stride: IntPair = (2, 2)
    padding: Union[str, IntPair] = "valid"
    mode: str = "max"  # max | avg | sum (pnorm: not ported yet)
    pnorm: int = 2

    def output_shape(self, input_shape: Shape) -> Shape:
        _check_padding(self, self.padding)
        h, w, c = input_shape
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        return (_out_size(h, kh, sh, 1, self.padding, 0),
                _out_size(w, kw, sw, 1, self.padding, 1), c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        kernel, stride = _pair(self.kernel), _pair(self.stride)
        if self.mode == "pnorm":
            raise NotImplementedError(
                "Subsampling2D mode='pnorm' is not ported yet (ROADMAP.md, "
                "Queue 1, 'The rest of nn/layers/{conv,norm,pooling}')")
        if self.mode not in ("max", "avg", "sum"):
            raise ValueError(f"Unknown pooling mode {self.mode}")
        (ph_lo, ph_hi), (pw_lo, pw_hi) = _pads(x.shape[1:3], kernel, stride,
                                               (1, 1), self.padding)
        fill = float("-inf") if self.mode == "max" else 0.0
        if ph_lo or ph_hi or pw_lo or pw_hi:
            x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi), value=fill)
        if self.mode == "max":
            # ties go to the first maximum in the window, as XLA's
            # select-and-scatter sends them
            return (_to_nhwc(F.max_pool2d(_to_nchw(x), kernel, stride)),
                    state, mask)
        # the window sum in x's dtype, element by element in window order,
        # as the reference's reduce_window adds
        (kh, kw), (sh, sw) = kernel, stride
        oh = (x.shape[1] - kh) // sh + 1
        ow = (x.shape[2] - kw) // sw + 1
        y = None
        for i in range(kh):
            for j in range(kw):
                sl = x[:, i: i + (oh - 1) * sh + 1: sh,
                       j: j + (ow - 1) * sw + 1: sw, :]
                y = sl if y is None else y + sl
        if self.mode == "avg":
            y = y / (kh * kw)
        return y, state, mask
