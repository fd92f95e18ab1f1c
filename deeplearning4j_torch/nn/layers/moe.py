"""Mixture-of-Experts — counterpart of ``deeplearning4j_tpu/nn/layers/moe.py``:
``MoE`` (a top-k routed expert FFN in the GShard/Switch capacity-dispatch
form: a one-hot (N, E, C) dispatch of tokens to expert slots, the experts
as batched products, a gate-weighted combine) and ``MoETransformerBlock``
(LN -> attention -> +res -> LN -> MoE -> +res; ``flash=True`` routes its
attention through the flash kernels).

The routing is the reference's exactly: the router's probabilities in
f32, the top k by a stable descending sort (``jax.lax.top_k`` takes the
lower index among equal values; ``torch.topk`` does not promise to), the
capacity ``int(capacity_factor * n * k / e)`` in Python floats, slot 0 of
every token placed before slot 1, a token past its expert's capacity
dropped (its output 0; the block's residual carries it). Padding tokens
take no slot. The GShard load-balancing loss is returned as the layer's
state ``"aux_loss"`` in training (0 otherwise); ``Sequential.score`` and
``Graph.score`` add it to the loss.

**Expert parallelism.** Under a sharded step whose mesh has an ``expert``
axis (``ACTIVE_MESH``, ``parallel/sharding.py``), each rank holds E/ep
experts (``w_up``, ``b_up``, ``w_down``, ``b_down`` placed over that axis
on their leading dimension, as the reference places them) while the
tokens and the router are replicated: every rank routes all tokens,
computes its own experts' slots and their share of the combine, and the
shares are summed over the expert group (``reduce_from``: all-reduce
forward, identity backward). The tokens enter the experts, and the
combine weights enter their share, through ``copy_to`` (identity
forward, all-reduce backward), so the router's and the input's gradients
are whole on every rank. The aux loss comes from the replicated routing,
as on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ...ops import activations, initializers
from ..api import ACTIVE_MESH, Layer, Shape, register_layer
from .attention import MultiHeadAttention
from .norm import layer_norm


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[:, None] == torch.arange(n, device=idx.device)[None]).to(dtype)


@register_layer
@dataclass(frozen=True)
class MoE(Layer):
    """A top-k routed mixture-of-experts FFN block: (..., D) -> (..., D)."""

    num_experts: int = 8
    top_k: int = 2
    mlp_ratio: int = 4
    capacity_factor: float = 1.25
    activation: str = "gelu"
    aux_loss_weight: float = 1e-2

    def output_shape(self, input_shape: Shape) -> Shape:
        return input_shape

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        d = input_shape[-1]
        h = d * self.mlp_ratio
        e = self.num_experts

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "w_router": initializers.init_param(gen, "xavier", (d, e),
                                                dtype=dtype, device=device),
            "w_up": initializers.init_param(gen, "xavier", (e, d, h),
                                            dtype=dtype, device=device),
            "b_up": zeros(e, h),
            "w_down": initializers.init_param(gen, "xavier", (e, h, d),
                                              dtype=dtype, device=device),
            "b_down": zeros(e, d),
        }, {"aux_loss": torch.zeros((), dtype=torch.float32, device=device)}

    def route(self, params, xf, valid_tok=None):
        """(probs (N, E), top-k indices (N, K), dispatch and combine
        (N, E, C) f32) of the token view ``xf``."""
        n = xf.shape[0]
        e, k = self.num_experts, min(self.top_k, self.num_experts)
        cap = max(1, int(self.capacity_factor * n * k / e))
        probs = activations.softmax((xf @ params["w_router"]).float(), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, gate_idx = vals[:, :k], idx[:, :k]
        if k > 1:  # renormalize the selected gates
            gate_vals = gate_vals / torch.clamp_min(
                gate_vals.sum(dim=-1, keepdim=True), 1e-9)
        if valid_tok is not None:
            gate_vals = gate_vals * valid_tok[:, None]
        combine = xf.new_zeros((n, e, cap), dtype=torch.float32)
        dispatch = xf.new_zeros((n, e, cap), dtype=torch.float32)
        counts = torch.zeros((e,), dtype=torch.int32, device=xf.device)
        for slot in range(k):
            onehot_e = _one_hot(gate_idx[:, slot], e, torch.int32)
            if valid_tok is not None:  # pads take no expert slot
                onehot_e = onehot_e * valid_tok[:, None].to(torch.int32)
            pos = (torch.cumsum(onehot_e, dim=0, dtype=torch.int32)
                   - onehot_e + counts[None, :])
            pos_tok = torch.sum(pos * onehot_e, dim=1, dtype=torch.int32)
            keep = (pos_tok < cap).to(torch.float32)
            d_slot = (onehot_e.to(torch.float32)[:, :, None]
                      * _one_hot(pos_tok, cap, torch.float32)[:, None, :]
                      * keep[:, None, None])
            dispatch = dispatch + d_slot
            combine = combine + d_slot * gate_vals[:, slot][:, None, None]
            counts = counts + torch.sum(onehot_e, dim=0, dtype=torch.int32)
        return probs, gate_idx, dispatch, combine

    def _expert_group(self, params):
        """The expert group of the active mesh (None outside one, or when
        its mesh has no expert axis); raises unless this rank holds its
        E/ep experts."""
        ctx = ACTIVE_MESH.get()
        group = getattr(ctx, "expert_group", None)
        if group is None:
            return None
        ep = dist.get_world_size(group)
        held = params["w_up"].shape[0]
        if self.num_experts % ep or held * ep != self.num_experts:
            raise ValueError(
                f"MoE under an expert axis of {ep}: this rank holds {held} of "
                f"{self.num_experts} experts; place w_up, b_up, w_down and "
                f"b_down over the expert axis (E/ep each)")
        return group

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        orig_shape = x.shape
        xf = x.reshape(-1, x.shape[-1])  # (N, D) token view
        e = self.num_experts
        valid_tok = None
        if mask is not None and mask.ndim == len(orig_shape) - 1:
            valid_tok = mask.reshape(-1).to(torch.float32)
        probs, gate_idx, dispatch, combine = self.route(params, xf, valid_tok)
        cdt = x.dtype
        group = self._expert_group(params)
        xin = xf
        if group is not None:  # this rank's experts: a slice of the routing
            from ...parallel.collectives import copy_to

            ep = dist.get_world_size(group)
            n_local = e // ep
            e0 = dist.get_rank(group) * n_local
            combine = copy_to(combine, group)[:, e0:e0 + n_local]
            dispatch = dispatch[:, e0:e0 + n_local]
            xin = copy_to(xf, group)
        x_e = torch.einsum("nec,nd->ecd", dispatch.to(cdt), xin)
        h = activations.get(self.activation)(
            torch.einsum("ecd,edh->ech", x_e, params["w_up"])
            + params["b_up"][:, None, :])
        y_e = (torch.einsum("ech,ehd->ecd", h, params["w_down"])
               + params["b_down"][:, None, :])
        y = torch.einsum("nec,ecd->nd", combine.to(cdt), y_e)
        if group is not None:
            from ...parallel.collectives import reduce_from

            y = reduce_from(y, group)
        if training:
            # GShard: E * sum_e f_e * P_e over top-1 routing (over real
            # tokens only under a padding mask)
            top1 = _one_hot(gate_idx[:, 0], e, torch.float32)
            if valid_tok is None:
                f_e, p_e = top1.mean(dim=0), probs.mean(dim=0)
            else:
                denom = torch.clamp_min(valid_tok.sum(), 1.0)
                f_e = (top1 * valid_tok[:, None]).sum(dim=0) / denom
                p_e = (probs * valid_tok[:, None]).sum(dim=0) / denom
            aux = self.aux_loss_weight * e * torch.sum(f_e * p_e)
        else:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return y.reshape(orig_shape), {"aux_loss": aux}, mask


@register_layer
@dataclass(frozen=True)
class MoETransformerBlock(Layer):
    """Pre-LN transformer block with an MoE FFN: LN -> MHA -> +res ->
    LN -> MoE -> +res (the Switch Transformer layer)."""

    num_heads: int = 8
    num_experts: int = 8
    top_k: int = 2
    mlp_ratio: int = 4
    capacity_factor: float = 1.25
    activation: str = "gelu"
    causal: bool = False
    flash: bool = False
    aux_loss_weight: float = 1e-2

    def _parts(self):
        mha = MultiHeadAttention(num_heads=self.num_heads, causal=self.causal,
                                 flash=self.flash)
        moe = MoE(num_experts=self.num_experts, top_k=self.top_k,
                  mlp_ratio=self.mlp_ratio,
                  capacity_factor=self.capacity_factor,
                  activation=self.activation,
                  aux_loss_weight=self.aux_loss_weight)
        return mha, moe

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        d = input_shape[-1]
        mha, moe = self._parts()
        attn, _ = mha.init(gen, input_shape, dtype, device)
        moe_params, moe_state = moe.init(gen, input_shape, dtype, device)

        def full(value):
            return torch.full((d,), value, dtype=dtype, device=device)

        return {"ln1_g": full(1.0), "ln1_b": full(0.0),
                "ln2_g": full(1.0), "ln2_b": full(0.0),
                "attn": attn, "moe": moe_params}, moe_state

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        mha, moe = self._parts()
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        a, _, _ = mha.apply(params["attn"], {}, h, training=training, rng=rng,
                            mask=mask)
        x = x + a
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        m, moe_state, _ = moe.apply(params["moe"], state, h,
                                    training=training, rng=rng, mask=mask)
        return x + m, moe_state, mask
