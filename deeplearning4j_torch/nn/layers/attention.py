"""Attention layers — counterpart of
``deeplearning4j_tpu/nn/layers/attention.py``.

Same params (one fused QKV projection, (in, out) weights), same routing:
``flash=True`` with no mask or a (B, T) key mask goes to
``ops.flash_attention`` (on the card: the hand-written CUDA kernel);
everything else takes the dense path, with f32 scores whatever the input
dtype. Both paths are differentiable (on the card the flash gradient runs
the hand-written backward kernels). Training-time dropout (which the
reference routes to the dense path) is not ported yet and raises.
``ring=True`` behaves as the reference does outside a sequence-parallel
trace: flash or dense.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional

import torch
import torch.utils.checkpoint

from ...ops import activations, initializers
from ...ops.flash_attention import flash_attention
from ..api import Layer, no_training_dropout, register_layer
from .norm import layer_norm


def dot_product_attention(q, k, v, *, mask=None, scale=None):
    """(B, T, H, D) attention with f32 scores. mask: (B, 1|H, Tq, Tk),
    bool (True = attend) or additive."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        else:
            scores = scores + mask
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def rope_rotate(x, positions, base: float = 10000.0):
    """Rotary position embedding on (B, T, H, Dh) at absolute ``positions``
    ((T,) or (B, T)); the rotation is f32 and cast back to x's dtype."""
    Dh = x.shape[-1]
    if Dh % 2:
        raise ValueError(f"rope needs an even head dim, got {Dh}")
    half = Dh // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32, device=x.device)
                   / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * inv
    if ang.ndim == 2:
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    else:
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _validate_window(causal: bool, window: Optional[int]) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("window= requires causal=True (sliding-window "
                         "attention is a causal-LM construct)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


@register_layer
@dataclass(frozen=True)
class MultiHeadAttention(Layer):
    """Fused-QKV multi-head self-attention. (B, T, D) -> (B, T, D).

    ``num_kv_heads`` < ``num_heads`` is grouped-query attention: the KV
    projection shrinks, and KV groups are repeated up to the query heads
    before attention. ``ragged=True`` declares (B, T) masks right-padded,
    so the flash path takes per-example lengths instead of the exact key
    mask. ``window`` (causal only) is sliding-window attention."""

    num_heads: int = 8
    causal: bool = False
    attn_dropout: float = 0.0
    flash: bool = False
    ring: bool = False
    rope: bool = False
    rope_base: float = 10000.0
    num_kv_heads: Optional[int] = None
    ragged: bool = False
    window: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        h = self.num_kv_heads or self.num_heads
        if self.num_heads % h:
            raise ValueError(f"num_heads={self.num_heads} must be divisible "
                             f"by num_kv_heads={h}")
        return h

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        d = input_shape[-1]
        d_kv = d // self.num_heads * self.kv_heads
        scheme = self.weight_init or "xavier"
        wqkv = initializers.init_param(gen, scheme, (d, d + 2 * d_kv),
                                       dtype=dtype, device=device)
        wo = initializers.init_param(gen, scheme, (d, d), dtype=dtype,
                                     device=device)
        return {"w_qkv": wqkv,
                "b_qkv": torch.zeros((d + 2 * d_kv,), dtype=dtype, device=device),
                "w_o": wo,
                "b_o": torch.zeros((d,), dtype=dtype, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        _validate_window(self.causal, self.window)
        B, T, D = x.shape
        H, Hkv = self.num_heads, self.kv_heads
        hd = D // H
        qkv = x @ params["w_qkv"] + params["b_qkv"]
        q, k, v = torch.split(qkv, [D, Hkv * hd, Hkv * hd], dim=-1)
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, Hkv, hd)
        v = v.reshape(B, T, Hkv, hd)
        if self.rope:
            pos = torch.arange(T, device=x.device)
            q = rope_rotate(q, pos, self.rope_base)
            k = rope_rotate(k, pos, self.rope_base)
        if Hkv != H:
            # each KV head serves H // Hkv consecutive query heads
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        no_training_dropout(self, self.attn_dropout, training)
        if self.ring and self.window is not None:
            warnings.warn(
                "ring=True is disabled because window= is set: ring "
                "attention computes full causal attention, so the window "
                "routes through flash/dense instead.", stacklevel=2)
        if self.flash and (mask is None or mask.ndim == 2):
            if mask is not None and self.ragged:
                y = flash_attention(q, k, v, causal=self.causal,
                                    lengths=mask.to(torch.int32).sum(dim=-1),
                                    window=self.window)
            else:
                y = flash_attention(q, k, v, causal=self.causal,
                                    key_mask=mask, window=self.window)
        else:
            attn_mask = None
            if self.causal:
                pos = torch.arange(T, device=x.device)
                band = pos[:, None] >= pos[None, :]
                if self.window is not None:
                    band = band & (pos[:, None] - pos[None, :] < self.window)
                attn_mask = band[None, None]
            if mask is not None:
                key_mask = mask[:, None, None, :].to(torch.bool)
                attn_mask = key_mask if attn_mask is None else attn_mask & key_mask
            y = dot_product_attention(q, k, v, mask=attn_mask)
        y = y.reshape(B, T, D) @ params["w_o"] + params["b_o"]
        return y, state, mask


@register_layer
@dataclass(frozen=True)
class TransformerEncoderBlock(Layer):
    """Pre-LN transformer block: LN -> MHA -> +res -> LN -> MLP -> +res.
    ``remat=True`` checkpoints the block (``torch.utils.checkpoint``): its
    activations are recomputed in the backward instead of kept."""

    num_heads: int = 8
    mlp_ratio: int = 4
    activation: str = "gelu"
    causal: bool = False
    dropout_rate: float = 0.0
    flash: bool = False
    ring: bool = False
    remat: bool = False
    rope: bool = False
    rope_base: float = 10000.0
    num_kv_heads: Optional[int] = None
    window: Optional[int] = None
    ragged: bool = False

    def _mha(self) -> MultiHeadAttention:
        return MultiHeadAttention(num_heads=self.num_heads, causal=self.causal,
                                  flash=self.flash, ring=self.ring,
                                  rope=self.rope, rope_base=self.rope_base,
                                  num_kv_heads=self.num_kv_heads,
                                  window=self.window, ragged=self.ragged)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        d = input_shape[-1]
        attn, _ = self._mha().init(gen, input_shape, dtype, device)
        h = d * self.mlp_ratio

        def full(n, value):
            return torch.full((n,), value, dtype=dtype, device=device)

        return {
            "ln1_g": full(d, 1.0), "ln1_b": full(d, 0.0),
            "ln2_g": full(d, 1.0), "ln2_b": full(d, 0.0),
            "attn": attn,
            "w_up": initializers.init_param(gen, "xavier", (d, h),
                                            dtype=dtype, device=device),
            "b_up": full(h, 0.0),
            "w_down": initializers.init_param(gen, "xavier", (h, d),
                                              dtype=dtype, device=device),
            "b_down": full(d, 0.0),
        }, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        no_training_dropout(self, self.dropout_rate, training)
        if self.remat and torch.is_grad_enabled():
            y = torch.utils.checkpoint.checkpoint(
                lambda p, x_: self._body(p, x_, rng, mask, training),
                params, x, use_reentrant=False)
        else:
            y = self._body(params, x, rng, mask, training)
        return y, state, mask

    def _body(self, params, x, rng, mask, training):
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        a, _, _ = self._mha().apply(params["attn"], {}, h, training=training,
                                    rng=rng, mask=mask)
        x = x + a
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        act = activations.get(self.activation)
        m = act(h @ params["w_up"] + params["b_up"]) @ params["w_down"] \
            + params["b_down"]
        return x + m


@register_layer
@dataclass(frozen=True)
class PositionalEmbedding(Layer):
    """Learned positional embedding added to (B, T, D) inputs."""

    max_len: int = 512

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        d = input_shape[-1]
        return {"pos": 0.02 * torch.randn((self.max_len, d), generator=gen,
                                          dtype=dtype, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return x + params["pos"][:x.shape[1]], state, mask
