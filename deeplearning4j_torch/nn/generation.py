"""Autoregressive generation — counterpart of
``deeplearning4j_tpu/nn/generation.py``: KV-cache decode and sampling for
``Sequential`` token models (the CausalLM family).

The reference compiles prefill and a ``lax.scan`` of decode steps into one
program; here the same steps run eagerly with static shapes. Attention
layers decode against fixed-capacity KV caches that are written in place
(the reference donates those buffers), and validity is a mask computed
from the absolute position, so nothing changes shape between steps.

Rounding follows the reference exactly. Caches take the model's param
dtype (``model.dtype``), as the reference's do: under a bf16
``compute_dtype`` with f32 params the keys and values are stored in f32,
attention returns f32, and from the first block's output projection on
the reference's type promotion carries f32 activations against the
bf16-rounded weights. The port promotes where JAX promotes: a matmul of
an f32 activation with a bf16 weight runs in f32 on the weight's
bf16-rounded value.

One-hot char models and recurrent layers (``TextGenerationLSTM``,
``GravesLSTMCharRNN``) are not ported yet: ROADMAP.md, Queue 1,
"GravesLSTM char-RNN".
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import activations as _act
from .layers import (ActivationLayer, Dense, EmbeddingSequence, LayerNorm,
                     MultiHeadAttention, Output, PositionalEmbedding,
                     TransformerEncoderBlock)
from .layers.attention import rope_rotate
from .layers.norm import layer_norm
from .model import DTYPES, Sequential, _layer_key

# Layers that act on each position independently: safe to run on a decode
# chunk with their ordinary eval-time apply(). Anything else but the
# attention/positional special cases and the final Output is rejected by
# generate() up front (the reference's list, as far as the port has it).
_TOKEN_LOCAL = (ActivationLayer, Dense, EmbeddingSequence, LayerNorm)

_NOT_PORTED_RNN = ("one-hot char models and recurrent layers are not ported "
                   "yet (ROADMAP.md, Queue 1, 'GravesLSTM char-RNN')")

# --------------------------------------------------------------------------
# KV-cache layout contract (the reference's, nn/generation.py)
#
# dense  {"k": (B, C, Hkv, hd), "v": (B, C, Hkv, hd)}
#     Position p of row b lives at [b, p]; C is the fixed capacity.
#
# paged  {"k_pool": (N, bs, Hkv, hd), "v_pool": (N, bs, Hkv, hd),
#         "tables": (B, maxb) int}
#     Position p of row b lives at pool[tables[b, p // bs], p % bs].
#     Physical block 0 is the TRASH block: unallocated table entries point
#     at it, so writes past a row's live region land there and reads of it
#     are always causally masked. Appends whose logical block falls past
#     the table (right-padding overflow) go to block 0 too.
#
# ``pos`` is a Python int (the whole batch at one offset: prefill,
# lockstep decode) or a (B,) tensor (per-row offsets: continuous
# batching). Position p is always written before it is read unmasked, so
# stale values past the live length are never observable.
# --------------------------------------------------------------------------


def _pos_vec(pos):
    """None if ``pos`` is a scalar offset, else the (B,) per-row vector."""
    return pos if isinstance(pos, torch.Tensor) and pos.ndim == 1 else None


def cache_append(cache, k, v, pos):
    """Write a chunk's keys/values (B, Tq, Hkv, hd) at absolute offset
    ``pos``, in place. Returns the cache (same tensors, same shapes)."""
    B, Tq = k.shape[:2]
    dev = k.device
    steps = torch.arange(Tq, device=dev)
    pv = _pos_vec(pos)
    if "k_pool" in cache:  # paged
        kp, vp, tables = cache["k_pool"], cache["v_pool"], cache["tables"]
        bs, maxb = kp.shape[1], tables.shape[1]
        p = pv.long() if pv is not None else torch.full(
            (B,), int(pos), dtype=torch.long, device=dev)
        wpos = p[:, None] + steps[None]  # (B, Tq)
        blk, off = wpos // bs, wpos % bs
        rows = torch.arange(B, device=dev)[:, None]
        # logical blocks past the table (right-padded garbage) -> trash 0
        phys = torch.where(blk < maxb,
                           tables[rows, blk.clamp(max=maxb - 1)].long(), 0)
        kp[phys, off] = k.to(kp.dtype)
        vp[phys, off] = v.to(vp.dtype)
        return cache
    ck, cv = cache["k"], cache["v"]
    C = ck.shape[1]
    if pv is None:
        # lax.dynamic_update_slice clamps its start so the update fits
        start = min(max(int(pos), 0), C - Tq)
        ck[:, start:start + Tq] = k.to(ck.dtype)
        cv[:, start:start + Tq] = v.to(cv.dtype)
        return cache
    # per-row offsets; writes past the capacity are dropped, as the
    # reference's scatter drops them
    wpos = pv.long()[:, None] + steps[None]
    rows = torch.arange(B, device=dev)[:, None].expand(B, Tq)
    if Tq == 1:  # without a host sync: an out-of-range row rewrites itself
        inb = (wpos < C)[..., None, None]
        idx = wpos.clamp(max=C - 1)
        ck[rows, idx] = torch.where(inb, k.to(ck.dtype), ck[rows, idx])
        cv[rows, idx] = torch.where(inb, v.to(cv.dtype), cv[rows, idx])
    else:
        keep = wpos < C
        ck[rows[keep], wpos[keep]] = k[keep].to(ck.dtype)
        cv[rows[keep], wpos[keep]] = v[keep].to(cv.dtype)
    return cache


def cache_read(cache):
    """The cache as (K, V), each (B, L, Hkv, hd) in logical position order.
    Dense: the buffers themselves (L = C). Paged: a block-table gather of
    the whole table (L = maxb * bs); entries past a row's live length are
    garbage the caller must mask causally."""
    if "k_pool" in cache:
        kp, tables = cache["k_pool"], cache["tables"].long()
        B, maxb = tables.shape
        bs, Hkv, hd = kp.shape[1:]
        ck = kp[tables].reshape(B, maxb * bs, Hkv, hd)
        cv = cache["v_pool"][tables].reshape(B, maxb * bs, Hkv, hd)
        return ck, cv
    return cache["k"], cache["v"]


def _mm(x, w, casts):
    """``x @ w`` under JAX's type promotion: mixed float dtypes run in the
    wider one (bf16 -> f32 is exact)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), _cast(w, dt, casts)
    return x @ w


def _mha_decode(num_heads: int, params, x, cache, pos, *, rope=False,
                rope_base=10000.0, num_kv_heads=None, window=None,
                casts=None):
    """Decode a query chunk ``x`` (B, Tq, D) at absolute offset ``pos``
    against a KV cache in either layout. Returns (y, cache). Causal by
    construction: token t sees cache slots 0..pos+t (and, with ``window``,
    only the last ``window`` of them). With ``rope`` the chunk's q/k
    rotate at their absolute positions before k enters the cache. With
    GQA the query heads fold into (Hkv, G) so the cache is consumed at Hkv
    heads, never repeated to H. Scores are f32 (q and the cache widened,
    exactly); the softmax weights round to the cache dtype."""
    B, Tq, D = x.shape
    H = num_heads
    Hkv = num_kv_heads or H
    hd = D // H
    qkv = _mm(x, params["w_qkv"], casts) + params["b_qkv"]
    q, k, v = torch.split(qkv, [D, Hkv * hd, Hkv * hd], dim=-1)
    q = q.reshape(B, Tq, H, hd)
    k = k.reshape(B, Tq, Hkv, hd)
    v = v.reshape(B, Tq, Hkv, hd)
    dev = x.device
    steps = torch.arange(Tq, device=dev)
    pv = _pos_vec(pos)
    if rope:
        abs_pos = (pos + steps) if pv is None else pv[:, None] + steps[None]
        q = rope_rotate(q, abs_pos, rope_base)
        k = rope_rotate(k, abs_pos, rope_base)
    cache = cache_append(cache, k, v, pos)
    ck, cv = cache_read(cache)
    cols = torch.arange(ck.shape[1], device=dev)
    scale = 1.0 / math.sqrt(hd)
    if pv is None:
        qpos = pos + steps[:, None]  # (Tq, 1)
        valid = cols[None, :] <= qpos  # (Tq, C)
        if window is not None:
            valid = valid & (qpos - cols[None, :] < window)
        vmask, vmask_g = valid[None, None], valid[None, None, None]
    else:
        qpos = pv[:, None, None] + steps[None, :, None]  # (B, Tq, 1)
        valid = cols[None, None, :] <= qpos  # (B, Tq, C)
        if window is not None:
            valid = valid & (qpos - cols[None, None, :] < window)
        vmask, vmask_g = valid[:, None], valid[:, None, None]
    if Hkv != H:
        qg = q.reshape(B, Tq, Hkv, H // Hkv, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              ck.float()) * scale
        scores = scores.masked_fill(~vmask_g, -1e30)
        w = torch.softmax(scores, dim=-1).to(cv.dtype)
        y = torch.einsum("bhgqk,bkhd->bqhgd", w, cv).reshape(B, Tq, D)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              ck.float()) * scale
        scores = scores.masked_fill(~vmask, -1e30)
        w = torch.softmax(scores, dim=-1).to(cv.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", w, cv).reshape(B, Tq, D)
    y = _mm(y, params["w_o"], casts) + params["b_o"]
    return y, cache


def cache_spec(model: Sequential):
    """The KV-cached attention layers of ``model`` as
    ``[(layer_key, kv_heads, head_dim), ...]``: what a cache builder
    (``serve/paged.py``'s block pools) needs."""
    spec = []
    for i, layer in enumerate(model.layers):
        if isinstance(layer, (TransformerEncoderBlock, MultiHeadAttention)):
            d = model._shapes[i][-1]
            hkv = layer.num_kv_heads or layer.num_heads
            spec.append((_layer_key(i, layer), hkv, d // layer.num_heads))
    return spec


def init_caches(model: Sequential, batch: int, capacity: int, dtype):
    """Zero-filled dense caches for every attention layer, on the model's
    device. For the paged layout, build pools from :func:`cache_spec`."""
    caches: Dict[str, Any] = {}
    for lk, hkv, hd in cache_spec(model):
        caches[lk] = {
            "k": torch.zeros((batch, capacity, hkv, hd), dtype=dtype,
                             device=model.device),
            "v": torch.zeros((batch, capacity, hkv, hd), dtype=dtype,
                             device=model.device)}
    return caches


def _cast(t, dtype, casts):
    """``t`` in ``dtype``; with a ``casts`` dict the copy is memoized on
    the source tensor's identity (the memo holds the source, so the
    identity stays valid)."""
    if t.dtype == dtype or not t.is_floating_point():
        return t
    if casts is None:
        return t.to(dtype)
    key = (id(t), dtype)
    hit = casts.get(key)
    if hit is None:
        hit = casts[key] = (t, t.to(dtype))
    return hit[1]


def _cast_tree(tree, dtype, casts):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, casts) for k, v in tree.items()}
    return _cast(tree, dtype, casts)


def cast_bytes(casts: Optional[dict]) -> int:
    """Device bytes held by a cast memo (the copies, not their sources)."""
    return sum(c.numel() * c.element_size() for _, c in (casts or {}).values())


def decode_forward(model: Sequential, params, state, x, caches, pos, *,
                   casts: Optional[dict] = None):
    """Run one decode chunk through the stack. ``x``: (B, Tq) int ids at
    absolute offset ``pos`` (an int, or a (B,) tensor when every row sits
    at its own offset); returns (logits (B, Tq, V), caches), the caches
    written in place. The final Output layer contributes its
    pre-activation. Params are cast to the compute dtype on every call, as
    the reference does; a ``casts`` dict memoizes those copies across
    calls (same bits: callers keep one per params generation)."""
    cdt = (DTYPES[model.config.compute_dtype]
           if model.config.compute_dtype else None)
    if cdt is not None and x.is_floating_point():
        x = x.to(cdt)
    new = dict(caches)
    mask = None
    for i, layer in enumerate(model.layers):
        k = _layer_key(i, layer)
        p = params.get(k, {})
        if cdt is not None:
            p = _cast_tree(p, cdt, casts)
        if isinstance(layer, TransformerEncoderBlock):
            h = layer_norm(x, p["ln1_g"], p["ln1_b"])
            a, new[k] = _mha_decode(layer.num_heads, p["attn"], h, new[k],
                                    pos, rope=layer.rope,
                                    rope_base=layer.rope_base,
                                    num_kv_heads=layer.num_kv_heads,
                                    window=layer.window, casts=casts)
            x = x + a
            h = layer_norm(x, p["ln2_g"], p["ln2_b"])
            act = _act.get(layer.activation)
            m = _mm(act(_mm(h, p["w_up"], casts) + p["b_up"]), p["w_down"],
                    casts) + p["b_down"]
            x = x + m
        elif isinstance(layer, MultiHeadAttention):
            x, new[k] = _mha_decode(layer.num_heads, p, x, new[k], pos,
                                    rope=layer.rope,
                                    rope_base=layer.rope_base,
                                    num_kv_heads=layer.num_kv_heads,
                                    window=layer.window, casts=casts)
        elif isinstance(layer, PositionalEmbedding):
            Tq = x.shape[1]
            pv = _pos_vec(pos)
            if pv is None:  # lax.dynamic_slice clamps its start
                start = min(max(int(pos), 0), p["pos"].shape[0] - Tq)
                x = x + p["pos"][start:start + Tq]
            else:  # per-row offsets; positions past the table (pad
                # garbage, masked or discarded) clip to its last row
                idx = (pv[:, None] + torch.arange(Tq, device=x.device)[None]
                       ).clamp(max=p["pos"].shape[0] - 1)
                x = x + p["pos"][idx]
        elif isinstance(layer, Output):  # incl. RnnOutput
            w = p["w"]
            y = _mm(x, w, casts)
            x = y + p["b"] if layer.use_bias else y
        else:  # token-local layers, their params at the activation's dtype
            if x.is_floating_point() and cdt is not None:
                p = _cast_tree(p, torch.promote_types(x.dtype, cdt), casts)
            x, _, mask = layer.apply(p, state.get(k, {}), x,
                                     training=False, mask=mask)
    if cdt is not None:
        x = x.to(torch.float32)
    return x, new


def sample_logits(logits, rng: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: Optional[int] = None):
    """Sample token ids (B,) from (B, V) logits. ``temperature=0`` is
    greedy; ``top_k`` keeps the logits >= the k-th largest (ties
    included). Sampling is Gumbel-max with noise from ``rng``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, -1e30))
    return categorical(logits, [rng] if rng is not None else None)


def categorical(logits, gens=None):
    """argmax(logits + Gumbel noise) per row of (B, V) ``logits``: row b
    draws its noise from ``gens[b]`` (one ``torch.Generator`` a row, on the
    logits' device; a None entry draws nothing, and its row is the caller's
    to discard), or all rows from the default generator."""
    B, V = logits.shape
    dev = logits.device
    if gens is None:
        u = torch.rand((B, V), device=dev)
    elif len(gens) == 1 and B > 1:
        u = torch.rand((B, V), generator=gens[0], device=dev)
    else:
        u = torch.stack([torch.rand(V, generator=g, device=dev)
                         if g is not None
                         else torch.full((V,), 0.5, device=dev)
                         for g in gens])
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def _check_decodable(model: Sequential, total: int) -> None:
    for i, layer in enumerate(model.layers):
        if isinstance(layer, PositionalEmbedding):
            if layer.max_len < total:
                raise ValueError(
                    f"PositionalEmbedding(max_len={layer.max_len}) is shorter "
                    f"than prompt+new tokens {total}")
        elif isinstance(layer, (TransformerEncoderBlock, MultiHeadAttention)):
            if not layer.causal:
                raise ValueError(
                    f"layer {i} {type(layer).__name__}(causal=False) cannot "
                    f"be decoded autoregressively — generation needs causal "
                    f"attention")
        elif isinstance(layer, _TOKEN_LOCAL):
            pass
        elif isinstance(layer, Output) and i == len(model.layers) - 1:
            pass
        else:
            raise ValueError(
                f"generate() does not support layer {i} "
                f"{type(layer).__name__}: it is not token-local along the "
                f"sequence (decoding it one token at a time would disagree "
                f"with the full forward pass)")


def generate(model: Sequential, prompt, max_new_tokens: int, *,
             params=None, state=None, temperature: float = 1.0,
             top_k: Optional[int] = None,
             rng: Optional[torch.Generator] = None, seed: int = 0,
             capacity: Optional[int] = None) -> np.ndarray:
    """Autoregressively continue ``prompt`` ((B, Tp) int token ids) for
    ``max_new_tokens`` tokens; returns the generated ids (B, N) int32.

    Prefill of the whole prompt, then one decode step a token, on the
    model's device. ``capacity`` (default Tp + max_new_tokens) sizes the
    KV caches. Sampling draws from ``rng`` (a ``torch.Generator`` on the
    model's device), else from a generator seeded with ``seed``."""
    params = params if params is not None else model.params
    state = state if state is not None else model.state
    if params is None:
        raise ValueError("call init() first")
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, torch.Tensor) else prompt, device=model.device)
    if prompt.ndim == 3 or prompt.is_floating_point():
        raise NotImplementedError(_NOT_PORTED_RNN)
    B, Tp = prompt.shape
    total = Tp + max_new_tokens
    capacity = capacity or total
    if capacity < total:
        raise ValueError(f"capacity {capacity} < prompt+new tokens {total}")
    _check_decodable(model, total)
    if rng is None:
        rng = torch.Generator(device=model.device)
        rng.manual_seed(seed)
    casts: dict = {}
    toks = []
    with torch.inference_mode():
        caches = init_caches(model, B, capacity, model.dtype)
        logits, caches = decode_forward(model, params, state, prompt, caches,
                                        0, casts=casts)
        last = logits[:, -1]
        for i in range(max_new_tokens):
            tok = sample_logits(last, rng, temperature, top_k)
            toks.append(tok)
            if i + 1 < max_new_tokens:
                lg, caches = decode_forward(model, params, state,
                                            tok[:, None].to(prompt.dtype),
                                            caches, Tp + i, casts=casts)
                last = lg[:, -1]
    return torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
