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

Every layer of the reference's module is here. ``Conv1D`` is a 2-D
convolution over a (B, T, 1, C) view. ``Deconv2D`` is
``lax.conv_transpose`` with ``transpose_kernel=False``: a correlation of
the stride-dilated input with the unflipped HWIO kernel, padded by XLA's
rule for transposed convolutions (``_deconv_pads``); the port runs
``F.conv_transpose2d`` with the kernel flipped and its channels swapped
(the same function with no padding) and crops or zero-pads the result to
those pads. Depthwise and separable convolutions are grouped cuDNN
convolutions. Masks of 1-D layers are subsampled by the stride or cropped
with the time axis, as the reference's are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ...ops import activations, initializers
from ...ops.activations import weak_scalar
from ..api import Layer, Shape, apply_input_dropout, register_layer

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


def _conv2d(x, w, stride, padding, dilation=(1, 1), groups: int = 1):
    """NHWC ``x`` correlated with HWIO ``w`` as ``lax.conv_general_dilated``
    does, padding by the reference's rule."""
    kernel = tuple(w.shape[:2])
    stride, dilation = _pair(stride), _pair(dilation)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = _pads(x.shape[1:3], kernel, stride,
                                           dilation, padding)
    if ph_lo != ph_hi or pw_lo != pw_hi:
        x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
        pad = (0, 0)
    else:
        pad = (ph_lo, pw_lo)
    # HWIO -> OHWI contiguous -> OIHW channels_last view
    w = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    return _to_nhwc(F.conv2d(_to_nchw(x), w, None, stride, pad, dilation,
                             groups))


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
        x = apply_input_dropout(self, x, rng, training)
        y = _conv2d(x, params["w"], self.stride, self.padding, self.dilation,
                    self.groups)
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


def _integer_pow(x, p: int):
    """``x ** p`` for an int ``p`` as XLA's ``integer_pow`` expands it:
    square and multiply, each product rounded in x's dtype."""
    if p == 0:
        return torch.ones_like(x)
    acc, n = None, abs(p)
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return 1.0 / acc if p < 0 else acc


def _window_sum(x, kernel, stride):
    """The window sums of a padded NHWC ``x`` in x's dtype, element by
    element in window order, as the reference's ``reduce_window`` adds."""
    (kh, kw), (sh, sw) = kernel, stride
    oh = (x.shape[1] - kh) // sh + 1
    ow = (x.shape[2] - kw) // sw + 1
    y = None
    for i in range(kh):
        for j in range(kw):
            sl = x[:, i: i + (oh - 1) * sh + 1: sh,
                   j: j + (ow - 1) * sw + 1: sw, :]
            y = sl if y is None else y + sl
    return y


def _pool2d(x, kernel, stride, padding, mode: str, pnorm: int = 2):
    """max, avg, sum or pnorm pooling of NHWC ``x``, the reference's
    ``reduce_window`` with its padding: -inf for max, 0 for the sums (avg
    divides by kh*kw, padding included)."""
    if mode not in ("max", "avg", "sum", "pnorm"):
        raise ValueError(f"Unknown pooling mode {mode}")
    (ph_lo, ph_hi), (pw_lo, pw_hi) = _pads(x.shape[1:3], kernel, stride,
                                           (1, 1), padding)
    if mode == "pnorm":
        x = _integer_pow(torch.abs(x), pnorm)
    fill = float("-inf") if mode == "max" else 0.0
    if ph_lo or ph_hi or pw_lo or pw_hi:
        x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi), value=fill)
    if mode == "max":
        # ties go to the first maximum in the window, as XLA's
        # select-and-scatter sends them
        return _to_nhwc(F.max_pool2d(_to_nchw(x), kernel, stride))
    y = _window_sum(x, kernel, stride)
    if mode == "avg":
        y = y / (kernel[0] * kernel[1])
    elif mode == "pnorm":
        y = y ** weak_scalar(1.0 / pnorm, y.dtype)
    return y


@register_layer
@dataclass(frozen=True)
class Subsampling2D(Layer):
    """SubsamplingLayer.java — max, avg, sum and pnorm pooling over NHWC.
    The sums are taken in x's dtype, one window element after another;
    pnorm sums ``|x| ** pnorm`` (XLA's ``integer_pow``) and takes the
    ``1/pnorm`` power, with the reference's gradient (infinite where a
    whole window is 0)."""

    kernel: IntPair = (2, 2)
    stride: IntPair = (2, 2)
    padding: Union[str, IntPair] = "valid"
    mode: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2

    def output_shape(self, input_shape: Shape) -> Shape:
        _check_padding(self, self.padding)
        h, w, c = input_shape
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        return (_out_size(h, kh, sh, 1, self.padding, 0),
                _out_size(w, kw, sw, 1, self.padding, 1), c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return (_pool2d(x, _pair(self.kernel), _pair(self.stride),
                        self.padding, self.mode, self.pnorm), state, mask)


def _out_size_1d(t: int, k: int, s: int, d: int, padding) -> int:
    if padding in ("same", "valid"):
        return _out_size(t, k, s, d, padding, 0)
    return _out_size(t, k, s, d, (int(padding), 0), 0)


def _pad_1d(padding):
    """A 1-D layer's padding as the (H, W) padding of its (B, T, 1, C)
    view."""
    return padding if isinstance(padding, str) else (int(padding), 0)


def _subsample_mask(mask, stride: int):
    return mask[:, ::stride] if (mask is not None and stride > 1) else mask


@register_layer
@dataclass(frozen=True)
class Conv1D(Layer):
    """Convolution1DLayer.java over (B, T, C) with (k, c_in, n_out)
    weights; a stride subsamples the mask."""

    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: Union[str, int] = "same"
    dilation: int = 1
    activation: str = "identity"
    use_bias: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        _check_padding(self, self.padding)
        t, _ = input_shape
        return (_out_size_1d(t, self.kernel, self.stride, self.dilation,
                             self.padding), self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        params = {"w": initializers.init_param(
            gen, self.weight_init or "relu",
            (self.kernel, input_shape[-1], self.n_out), kind="conv",
            dtype=dtype, device=device)}
        if self.use_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return params, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        x = apply_input_dropout(self, x, rng, training)
        y = _conv2d(x[:, :, None, :], params["w"][:, None],
                    (self.stride, 1), _pad_1d(self.padding),
                    (self.dilation, 1))[:, :, 0, :]
        if self.use_bias:
            y = y + params["b"]
        return (activations.get(self.activation)(y), state,
                _subsample_mask(mask, self.stride))


def _deconv_pads(k: int, s: int, padding, axis: int) -> Tuple[int, int]:
    """(lo, hi) padding of the stride-dilated input, as
    ``lax.conv_transpose`` sets it: for "same" and "valid" its transposed
    rule (``_conv_transpose_padding``), for explicit (ph, pw) the pair as
    given."""
    if padding == "same":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
        return lo, total - lo
    if padding == "valid":
        return k - 1, k + s - 2 + max(k - s, 0) - (k - 1)
    p = _pair(padding)[axis]
    return p, p


@register_layer
@dataclass(frozen=True)
class Deconv2D(Layer):
    """Deconvolution2D.java — ``lax.conv_transpose`` with HWIO weights,
    the kernel unflipped. ``F.conv_transpose2d`` with the kernel flipped and
    its channel axes swapped computes the same correlation padded by k - 1
    on each side; the result is then cropped (or zero-padded) to the
    reference's pads."""

    n_out: int = 0
    kernel: IntPair = (2, 2)
    stride: IntPair = (2, 2)
    padding: Union[str, IntPair] = "valid"
    activation: str = "identity"
    use_bias: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        _check_padding(self, self.padding)
        h, w, _ = input_shape
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        if self.padding == "same":
            oh, ow = h * sh, w * sw
        elif self.padding == "valid":
            oh, ow = (h - 1) * sh + kh, (w - 1) * sw + kw
        else:
            ph, pw = _pair(self.padding)
            oh, ow = (h - 1) * sh + kh - 2 * ph, (w - 1) * sw + kw - 2 * pw
        return (oh, ow, self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel)
        params = {"w": initializers.init_param(
            gen, self.weight_init or "relu",
            (kh, kw, input_shape[-1], self.n_out), kind="conv", dtype=dtype,
            device=device)}
        if self.use_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return params, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        w = params["w"]
        (kh, kw), stride = tuple(w.shape[:2]), _pair(self.stride)
        # HWIO -> (I, O, kh, kw), flipped
        wt = w.permute(2, 3, 0, 1).flip(2, 3)
        full = _to_nhwc(F.conv_transpose2d(_to_nchw(x), wt, None, stride))
        (h_lo, h_hi) = _deconv_pads(kh, stride[0], self.padding, 0)
        (w_lo, w_hi) = _deconv_pads(kw, stride[1], self.padding, 1)
        y = F.pad(full, (0, 0, w_lo - (kw - 1), w_hi - (kw - 1),
                         h_lo - (kh - 1), h_hi - (kh - 1)))
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


def _depthwise_shape(layer, input_shape, channels: int) -> Shape:
    _check_padding(layer, layer.padding)
    h, w, _ = input_shape
    (kh, kw), (sh, sw) = _pair(layer.kernel), _pair(layer.stride)
    return (_out_size(h, kh, sh, 1, layer.padding, 0),
            _out_size(w, kw, sw, 1, layer.padding, 1), channels)


@register_layer
@dataclass(frozen=True)
class DepthwiseConv2D(Layer):
    """DepthwiseConvolution2D.java — a per-channel conv (one group per
    input channel) with (kh, kw, 1, c_in * depth_multiplier) weights."""

    depth_multiplier: int = 1
    kernel: IntPair = (3, 3)
    stride: IntPair = (1, 1)
    padding: Union[str, IntPair] = "same"
    activation: str = "identity"
    use_bias: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        return _depthwise_shape(self, input_shape,
                                input_shape[-1] * self.depth_multiplier)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel)
        n = input_shape[-1] * self.depth_multiplier
        params = {"w": initializers.init_param(
            gen, self.weight_init or "relu", (kh, kw, 1, n), kind="conv",
            dtype=dtype, device=device)}
        if self.use_bias:
            params["b"] = torch.zeros((n,), dtype=dtype, device=device)
        return params, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        y = _conv2d(x, params["w"], self.stride, self.padding,
                    groups=x.shape[-1])
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


@register_layer
@dataclass(frozen=True)
class SeparableConv2D(Layer):
    """SeparableConvolution2D.java — depthwise, then a 1x1 pointwise conv
    (params ``w_depth``, ``w_point``, ``b``)."""

    n_out: int = 0
    kernel: IntPair = (3, 3)
    stride: IntPair = (1, 1)
    padding: Union[str, IntPair] = "same"
    depth_multiplier: int = 1
    activation: str = "identity"
    use_bias: bool = True

    def output_shape(self, input_shape: Shape) -> Shape:
        return _depthwise_shape(self, input_shape, self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel)
        n = input_shape[-1] * self.depth_multiplier
        init = self.weight_init or "relu"
        params = {
            "w_depth": initializers.init_param(
                gen, init, (kh, kw, 1, n), kind="conv", dtype=dtype,
                device=device),
            "w_point": initializers.init_param(
                gen, init, (1, 1, n, self.n_out), kind="conv", dtype=dtype,
                device=device)}
        if self.use_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return params, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        y = _conv2d(x, params["w_depth"], self.stride, self.padding,
                    groups=x.shape[-1])
        y = _conv2d(y, params["w_point"], (1, 1), "valid")
        if self.use_bias:
            y = y + params["b"]
        return activations.get(self.activation)(y), state, mask


@register_layer
@dataclass(frozen=True)
class Subsampling1D(Layer):
    """Subsampling1DLayer.java over (B, T, C): max, or the window sum
    (divided by the kernel for avg; any other mode sums, as the
    reference's does); a stride subsamples the mask."""

    kernel: int = 2
    stride: int = 2
    padding: Union[str, int] = "valid"
    mode: str = "max"

    def output_shape(self, input_shape: Shape) -> Shape:
        _check_padding(self, self.padding)
        t, c = input_shape
        return (_out_size_1d(t, self.kernel, self.stride, 1, self.padding),
                c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        mode = "max" if self.mode == "max" else (
            "avg" if self.mode == "avg" else "sum")
        y = _pool2d(x[:, :, None, :], (self.kernel, 1), (self.stride, 1),
                    _pad_1d(self.padding), mode)[:, :, 0, :]
        return y, state, _subsample_mask(mask, self.stride)


@register_layer
@dataclass(frozen=True)
class Upsampling2D(Layer):
    """Upsampling2D.java — nearest-neighbour repeat of rows and columns."""

    size: IntPair = (2, 2)

    def output_shape(self, input_shape: Shape) -> Shape:
        h, w, c = input_shape
        sh, sw = _pair(self.size)
        return (h * sh, w * sw, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        sh, sw = _pair(self.size)
        y = x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)
        return y, state, mask


@register_layer
@dataclass(frozen=True)
class Upsampling1D(Layer):
    """Upsampling1D.java — repeat each time step ``size`` times (the mask
    passes unchanged, as the reference's does)."""

    size: int = 2

    def output_shape(self, input_shape: Shape) -> Shape:
        t, c = input_shape
        return (t * self.size, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return x.repeat_interleave(self.size, dim=1), state, mask


def _pads_of(padding, n: int, layer: str):
    """A scalar, an (h, w) pair or the full tuple, as the reference reads
    ZeroPadding's ``padding``."""
    p = ((int(padding),) if isinstance(padding, int)
         else tuple(int(v) for v in padding))
    if len(p) == 1:
        p = p * 2
    if n == 4 and len(p) == 2:
        p = (p[0], p[0], p[1], p[1])
    if len(p) != n:
        want = "scalar, (h, w) or (t, b, l, r)" if n == 4 \
            else "scalar or (left, right)"
        raise ValueError(f"{layer} padding {padding!r}: expected {want}")
    return p


@register_layer
@dataclass(frozen=True)
class ZeroPadding2D(Layer):
    """ZeroPaddingLayer.java — (top, bottom, left, right); a scalar or an
    (h, w) pair pads symmetrically per axis."""

    padding: Sequence[int] = (1, 1, 1, 1)

    def output_shape(self, input_shape: Shape) -> Shape:
        h, w, c = input_shape
        t, b, l, r = _pads_of(self.padding, 4, "ZeroPadding2D")
        return (h + t + b, w + l + r, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        t, b, l, r = _pads_of(self.padding, 4, "ZeroPadding2D")
        return F.pad(x, (0, 0, l, r, t, b)), state, mask


@register_layer
@dataclass(frozen=True)
class ZeroPadding1D(Layer):
    """Zero padding of the time axis of (B, T, C), (left, right); a scalar
    pads both sides."""

    padding: Sequence[int] = (1, 1)

    def output_shape(self, input_shape: Shape) -> Shape:
        t, c = input_shape
        l, r = _pads_of(self.padding, 2, "ZeroPadding1D")
        return (t + l + r, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        l, r = _pads_of(self.padding, 2, "ZeroPadding1D")
        return F.pad(x, (0, 0, l, r)), state, mask


@register_layer
@dataclass(frozen=True)
class Cropping2D(Layer):
    """Cropping2D.java — (top, bottom, left, right)."""

    cropping: Sequence[int] = (0, 0, 0, 0)

    def output_shape(self, input_shape: Shape) -> Shape:
        h, w, c = input_shape
        t, b, l, r = self.cropping
        return (h - t - b, w - l - r, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        t, b, l, r = self.cropping
        h, w = x.shape[1], x.shape[2]
        return x[:, t: h - b, l: w - r, :], state, mask


@register_layer
@dataclass(frozen=True)
class Cropping1D(Layer):
    """Cropping1D.java — crop (left, right) time steps of (B, T, C) and of
    the mask."""

    cropping: Sequence[int] = (0, 0)

    def output_shape(self, input_shape: Shape) -> Shape:
        t, c = input_shape
        l, r = self.cropping
        return (t - l - r, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        l, r = self.cropping
        t = x.shape[1]
        if mask is not None:
            mask = mask[:, l: t - r]
        return x[:, l: t - r, :], state, mask


@register_layer
@dataclass(frozen=True)
class SpaceToDepth(Layer):
    """SpaceToDepthLayer.java — (H*b, W*b, C) -> (H, W, b*b*C), the new
    channels in (row in block, column in block, C) order."""

    block_size: int = 2

    def output_shape(self, input_shape: Shape) -> Shape:
        h, w, c = input_shape
        b = self.block_size
        return (h // b, w // b, c * b * b)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        B, H, W, C = x.shape
        b = self.block_size
        y = (x.reshape(B, H // b, b, W // b, b, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(B, H // b, W // b, b * b * C))
        return y, state, mask


@register_layer
@dataclass(frozen=True)
class SpaceToBatch(Layer):
    """SpaceToBatchLayer.java — spatial blocks into the batch axis:
    (B, H*b, W*b, C) -> (b*b*B, H, W, C), block offsets outermost."""

    block_size: int = 2

    def output_shape(self, input_shape: Shape) -> Shape:
        h, w, c = input_shape
        b = self.block_size
        return (h // b, w // b, c)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        B, H, W, C = x.shape
        b = self.block_size
        y = (x.reshape(B, H // b, b, W // b, b, C).permute(2, 4, 0, 1, 3, 5)
             .reshape(B * b * b, H // b, W // b, C))
        return y, state, mask
