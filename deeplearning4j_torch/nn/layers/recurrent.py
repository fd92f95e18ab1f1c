"""Recurrent layers — counterpart of
``deeplearning4j_tpu/nn/layers/recurrent.py``: LSTM, GravesLSTM (peepholes),
GRU, SimpleRnn, and the Bidirectional and LastTimeStep wrappers, with the
reference's ``"@type"`` names, param keys and (in, out) layouts.

The reference runs the recurrence as ``lax.scan``; here it is a Python
loop over T, and autograd differentiates through it (the reference's
``jax.grad`` through the scan). The input projection of every time step
is hoisted out of the loop into one (B·T, n_in) x (n_in, k·H) product, as
the reference does. ``scan_unroll`` is accepted so that configs cross
between the packages, and has no effect here.

Data layout: batch-major (B, T, F) at the API. Masks are (B, T): a masked
step holds the previous carry and emits the held h.

Rounding and dtypes follow the reference op for op: every product, bias
add and gate op rounds in its result's dtype (``ops.activations``'
``sigmoid``/``tanh`` carry JAX's rounding and gradients). ``apply`` builds
its zero carry in x's dtype, so a bf16 forward runs h and c in bf16; a
caller's carry in another dtype (``Sequential.init_carries`` and the
decode caches use the param dtype) promotes the step to the wider dtype,
as JAX's type promotion does (:func:`_mm`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ...ops import activations, initializers
from ..api import (Layer, Shape, apply_input_dropout, layer_from_dict,
                   register_layer)

Carry = Any


def _mm(a, b):
    """``a @ b`` under JAX's type promotion: mixed float dtypes run in the
    wider one (torch's matmul refuses mixed dtypes)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def _projected(x, w, b):
    """The hoisted input projection: (B, T, F) @ (F, kH) + b as one
    (B·T, F) product, reshaped back to (B, T, kH)."""
    B, T = x.shape[:2]
    return (_mm(x.reshape(B * T, -1), w) + b).reshape(B, T, -1)


def _hold(m_t, new, old):
    """``new`` where step ``m_t`` ((B,) mask) is live, else ``old``."""
    return torch.where(m_t[:, None] > 0, new, old)


class RecurrentLayer(Layer):
    """Base of the layers with a carry (rnnTimeStep / tBPTT state)."""

    def init_carry(self, batch: int, input_shape: Shape, dtype=torch.float32,
                   device=None) -> Carry:
        raise NotImplementedError

    def apply_sequence(self, params, x, carry, *, mask=None):
        """(B, T, F), carry -> (B, T, H), final carry. No dropout."""
        raise NotImplementedError

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        x = apply_input_dropout(self, x, rng, training)
        carry = self.init_carry(x.shape[0], tuple(x.shape[2:]), x.dtype,
                                x.device)
        y, _ = self.apply_sequence(params, x, carry, mask=mask)
        return y, state, mask

    def step(self, params, x_t, carry) -> Tuple[torch.Tensor, Carry]:
        """One time step (rnnTimeStep): (B, F), carry -> (B, H), carry."""
        y, new_carry = self.apply_sequence(params, x_t[:, None, :], carry)
        return y[:, 0], new_carry


def _mask_steps(mask, x):
    """The (B, T) mask in x's dtype, or None."""
    return None if mask is None else mask.to(x.dtype)


def _lstm_params(layer, gen, input_shape, dtype, device):
    n_in, H = input_shape[-1], layer.n_out
    scheme = layer.weight_init or "xavier"
    w_ih = initializers.init_param(gen, scheme, (n_in, 4 * H), dtype=dtype,
                                   device=device)
    w_hh = initializers.init_param(gen, scheme, (H, 4 * H), dtype=dtype,
                                   device=device)
    b = torch.zeros((4 * H,), dtype=dtype, device=device)
    b[H:2 * H] = layer.forget_gate_bias_init
    return {"w_ih": w_ih, "w_hh": w_hh, "b": b}


@register_layer
@dataclass(frozen=True)
class LSTM(RecurrentLayer):
    """LSTM.java, no peepholes. Gate order [i, f, g, o] in the 4H columns;
    the forget gate's bias starts at ``forget_gate_bias_init``."""

    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0
    scan_unroll: int = 1  # the reference's lax.scan unroll; no effect here

    def output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return _lstm_params(self, gen, input_shape, dtype, device), {}

    def init_carry(self, batch, input_shape, dtype=torch.float32,
                   device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def _cell(self, params, z, h_prev, c_prev):
        act = activations.get(self.activation)
        gate = activations.get(self.gate_activation)
        z = z + _mm(h_prev, params["w_hh"])
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i, f, o = gate(i), gate(f), gate(o)
        c_new = f * c_prev + i * act(g)
        return o * act(c_new), c_new

    def apply_sequence(self, params, x, carry, *, mask=None):
        xw = _projected(x, params["w_ih"], params["b"])
        m = _mask_steps(mask, x)
        h, c = carry
        ys = []
        for t in range(x.shape[1]):
            h_new, c_new = self._cell(params, xw[:, t], h, c)
            if m is not None:
                h_new = _hold(m[:, t], h_new, h)
                c_new = _hold(m[:, t], c_new, c)
            h, c = h_new, c_new
            ys.append(h)
        return torch.stack(ys, dim=1), (h, c)


@register_layer
@dataclass(frozen=True)
class GravesLSTM(LSTM):
    """GravesLSTM.java: LSTM with peepholes (Graves 2013), diagonal params
    ``w_ci``/``w_cf`` on c_{t-1} into the input and forget gates and
    ``w_co`` on c_t into the output gate (zero at init)."""

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        params = _lstm_params(self, gen, input_shape, dtype, device)
        H = self.n_out
        for k in ("w_ci", "w_cf", "w_co"):
            params[k] = torch.zeros((H,), dtype=dtype, device=device)
        return params, {}

    def _cell(self, params, z, h_prev, c_prev):
        act = activations.get(self.activation)
        gate = activations.get(self.gate_activation)
        z = z + _mm(h_prev, params["w_hh"])
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i = gate(i + c_prev * params["w_ci"])
        f = gate(f + c_prev * params["w_cf"])
        c_new = f * c_prev + i * act(g)
        o = gate(o + c_new * params["w_co"])
        return o * act(c_new), c_new


@register_layer
@dataclass(frozen=True)
class GRU(RecurrentLayer):
    """GRU, gate blocks [r, u, n]. ``reset_after=False`` (Cho et al. 2014):
    the reset gate multiplies h_{t-1} before the candidate's recurrent
    product, taken as two products over the column slices ``w_hh[:, :2H]``
    and ``w_hh[:, 2H:]`` as the reference takes them (one 3H product
    rounds differently in bf16). ``reset_after=True`` (the CuDNN/Keras
    variant): the reset gate after the product, with a recurrent bias
    ``b_hh``."""

    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    reset_after: bool = False
    scan_unroll: int = 1  # the reference's lax.scan unroll; no effect here

    def output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n_in, H = input_shape[-1], self.n_out
        scheme = self.weight_init or "xavier"
        params = {
            "w_ih": initializers.init_param(gen, scheme, (n_in, 3 * H),
                                            dtype=dtype, device=device),
            "w_hh": initializers.init_param(gen, scheme, (H, 3 * H),
                                            dtype=dtype, device=device),
            "b": torch.zeros((3 * H,), dtype=dtype, device=device)}
        if self.reset_after:
            params["b_hh"] = torch.zeros((3 * H,), dtype=dtype, device=device)
        return params, {}

    def init_carry(self, batch, input_shape, dtype=torch.float32,
                   device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def apply_sequence(self, params, x, carry, *, mask=None):
        H = self.n_out
        act = activations.get(self.activation)
        gate = activations.get(self.gate_activation)
        xw = _projected(x, params["w_ih"], params["b"])
        m = _mask_steps(mask, x)
        w_hh = params["w_hh"]
        if not self.reset_after:
            w_ru, w_n = w_hh[:, :2 * H], w_hh[:, 2 * H:]
        h = carry
        ys = []
        for t in range(x.shape[1]):
            xr, xu, xn = torch.chunk(xw[:, t], 3, dim=-1)
            if self.reset_after:
                hr, hu, hn = torch.chunk(_mm(h, w_hh) + params["b_hh"], 3,
                                         dim=-1)
                r = gate(xr + hr)
                u = gate(xu + hu)
                n = act(xn + r * hn)
            else:
                hz = _mm(h, w_ru)
                r = gate(xr + hz[:, :H])
                u = gate(xu + hz[:, H:])
                n = act(xn + _mm(r * h, w_n))
            h_new = (1.0 - u) * n + u * h
            h = h_new if m is None else _hold(m[:, t], h_new, h)
            ys.append(h)
        return torch.stack(ys, dim=1), h


@register_layer
@dataclass(frozen=True)
class SimpleRnn(RecurrentLayer):
    """SimpleRnn.java: h_t = act(x_t @ W + b + h_{t-1} @ R)."""

    n_out: int = 0
    activation: str = "tanh"
    scan_unroll: int = 1  # the reference's lax.scan unroll; no effect here

    def output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], self.n_out)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        n_in, H = input_shape[-1], self.n_out
        scheme = self.weight_init or "xavier"
        return {"w": initializers.init_param(gen, scheme, (n_in, H),
                                             dtype=dtype, device=device),
                "r": initializers.init_param(gen, scheme, (H, H),
                                             dtype=dtype, device=device),
                "b": torch.zeros((H,), dtype=dtype, device=device)}, {}

    def init_carry(self, batch, input_shape, dtype=torch.float32,
                   device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def apply_sequence(self, params, x, carry, *, mask=None):
        act = activations.get(self.activation)
        xw = _projected(x, params["w"], params["b"])
        m = _mask_steps(mask, x)
        h = carry
        ys = []
        for t in range(x.shape[1]):
            h_new = act(xw[:, t] + _mm(h, params["r"]))
            h = h_new if m is None else _hold(m[:, t], h_new, h)
            ys.append(h)
        return torch.stack(ys, dim=1), h


def _wrapped(fwd: Optional[dict]) -> RecurrentLayer:
    layer = layer_from_dict(fwd)
    if not isinstance(layer, RecurrentLayer):
        raise ValueError(f"{type(layer).__name__} is not a recurrent layer")
    return layer


@register_layer
@dataclass(frozen=True)
class Bidirectional(Layer):
    """Bidirectional.java, modes concat/add/mul/average. ``fwd`` is the
    wrapped recurrent layer's config dict; the backward direction runs it
    with its own params on the time-reversed input and mask, and its
    output is flipped back. GravesBidirectionalLSTM is
    Bidirectional(GravesLSTM)."""

    fwd: Optional[dict] = None
    mode: str = "concat"  # concat | add | mul | average

    def output_shape(self, input_shape: Shape) -> Shape:
        t, h = _wrapped(self.fwd).output_shape(input_shape)
        return (t, 2 * h) if self.mode == "concat" else (t, h)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        sub = _wrapped(self.fwd)
        pf, _ = sub.init(gen, input_shape, dtype, device)
        pb, _ = sub.init(gen, input_shape, dtype, device)
        return {"fwd": pf, "bwd": pb}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        sub = _wrapped(self.fwd)
        x = apply_input_dropout(self, x, rng, training)
        B, feat = x.shape[0], tuple(x.shape[2:])
        yf, _ = sub.apply_sequence(
            params["fwd"], x, sub.init_carry(B, feat, x.dtype, x.device),
            mask=mask)
        yb, _ = sub.apply_sequence(
            params["bwd"], torch.flip(x, dims=(1,)),
            sub.init_carry(B, feat, x.dtype, x.device),
            mask=None if mask is None else torch.flip(mask, dims=(1,)))
        yb = torch.flip(yb, dims=(1,))
        if self.mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "add":
            y = yf + yb
        elif self.mode == "mul":
            y = yf * yb
        elif self.mode == "average":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(self.mode)
        return y, state, mask


@register_layer
@dataclass(frozen=True)
class LastTimeStep(Layer):
    """LastTimeStep.java: the wrapped recurrent layer's output at the last
    unmasked step of each row (index sum(mask) - 1, clamped at 0); emits
    no mask."""

    fwd: Optional[dict] = None

    def output_shape(self, input_shape: Shape) -> Shape:
        return (_wrapped(self.fwd).output_shape(input_shape)[1],)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        return _wrapped(self.fwd).init(gen, input_shape, dtype, device)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        sub = _wrapped(self.fwd)
        x = apply_input_dropout(self, x, rng, training)
        carry = sub.init_carry(x.shape[0], tuple(x.shape[2:]), x.dtype,
                               x.device)
        y, _ = sub.apply_sequence(params, x, carry, mask=mask)
        if mask is None:
            return y[:, -1], state, None
        idx = torch.clamp(mask.sum(dim=1).to(torch.int32) - 1, min=0).long()
        rows = torch.arange(y.shape[0], device=y.device)
        return y[rows, idx], state, None
