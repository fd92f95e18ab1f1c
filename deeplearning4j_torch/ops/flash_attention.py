"""Flash attention: the attention of the port's transformer layers, forward
and backward.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. The public
function, its layout ((B, T, H, D)), its argument checks and its masking
contract are the reference's; the TPU-only arguments (``interpret``,
``block_q``, ``block_k``, ``backward``) are gone — the kernels pick their
own tiles.

- On a CUDA tensor the forward is a hand-written kernel
  (:func:`flash_fwd_cuda`): ``kernels/csrc/flash_fwd_sm90.cu`` (TMA and
  wgmma) for bf16 at head dims 64 and 128, ``kernels/csrc/flash_fwd.cu``
  for f32 and for bf16 at 16 and 32 (:func:`_fwd_route`); the gradient
  two backward kernels (:func:`flash_bwd_dq_cuda`,
  :func:`flash_bwd_dkv_cuda`), from ``kernels/csrc/flash_bwd_sm90.cu``
  (TMA and wgmma) for bf16 at head dim 64 and from
  ``kernels/csrc/flash_bwd.cu`` for the rest (:func:`_bwd_route`), joined
  by a ``torch.autograd.Function``; a failed build or launch raises:
  there is no fallback.
- On a CPU tensor the same Function runs :func:`flash_attention_reference`
  and :func:`flash_attention_backward_reference`, the plain PyTorch
  versions of the same functions, which the tests hold against the
  reference and against which the kernels are checked on the card.

The backward rounds as the reference's Pallas backward kernels do (``ds``
to k's and q's dtype, ``p`` to do's dtype before their products). The
reference's default backward for unwindowed calls is its pure-JAX scan,
which rounds nowhere: in bf16 the two differ by those roundings; in f32
they agree.

A row whose keys are all masked (or whose length is 0) outputs 0 and gets
zero gradients, as the reference's kernels give; the dense path returns
mean(v) there.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
SM90_HEAD_DIMS = (64, 128)    # bf16 head dims of flash_fwd_sm90.cu
SM90_BWD_HEAD_DIMS = (64,)    # bf16 head dims of flash_bwd_sm90.cu


def _valid(BH, T, lens, kmask, causal, window, device) -> torch.Tensor:
    """(BH, Tq, Tk) bool: which (query, key) pairs attend."""
    pos = torch.arange(T, device=device)
    valid = torch.ones((BH, T, T), dtype=torch.bool, device=device)
    if lens is not None:
        valid = valid & (pos[None, None, :] < lens.to(device)[:, None, None])
    if kmask is not None:
        valid = valid & (kmask.to(device) != 0)[:, None, :]
    if causal:
        valid = valid & (pos[None, :, None] >= pos[None, None, :])
    if window:
        valid = valid & ((pos[:, None] - pos[None, :]) < window)[None]
    return valid


def flash_attention_reference(q, k, v, lens=None, kmask=None, *,
                              scale: float, causal: bool = False,
                              window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash forward on (BH, T, D): returns ``(o, lse)``.

    Scores, softmax statistics and accumulation are f32; P is rounded to
    V's dtype before the P.V product, where the kernel rounds it. Masked
    scores are -1e30 and masked probabilities exactly 0, so an all-masked
    row gives o = 0 and lse = -1e30 + log(1e-30)."""
    BH, T, _ = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    valid = _valid(BH, T, lens, kmask, causal, window, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = (pv / l).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def flash_attention_backward_reference(q, k, v, do, lse, delta, lens=None,
                                       kmask=None, *, scale: float,
                                       causal: bool = False, window: int = 0
                                       ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch flash backward on (BH, T, D): returns ``(dq, dk, dv)``
    from the forward's ``lse`` and ``delta = rowsum(do * o)`` ((BH, T) f32).

    The reference's backward kernels, op for op: p = exp(s - lse) selected
    to 0 where a key is masked (a fully masked row has lse ~ -1e30, where
    exp overflows: selection, not a multiply, keeps it finite);
    ds = p (do.v - delta) scale; ds is rounded to k's dtype before ds.k and
    to q's before ds^T.q, p to do's before p^T.do; every sum is f32."""
    BH, T, _ = q.shape
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    valid = _valid(BH, T, lens, kmask, causal, window, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), kf)
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
# q, k, v, lens, kmask, o, lse, BH, T, D, is_bf16, scale, causal, window,
# stream: one C signature for both K1 libraries
_FWD_ARGS = ([_P] * 7 + [_I] * 4 + [ctypes.c_float, _I, _I, _P], _I)
_FWD_PROTOTYPES = {
    route: {f"dl4j_{route}": _FWD_ARGS,
            "dl4j_cuda_error_string": ([_I], ctypes.c_char_p)}
    for route in ("flash_fwd", "flash_fwd_sm90")
}
# q, k, v, do, lse, delta, lens, kmask, dq, BH, T, D, is_bf16, scale,
# causal, window, stream; dK/dV: ... dk, dv, BH, ...: one C signature each
# for both backward libraries
_DQ_ARGS = ([_P] * 9 + [_I] * 4 + [ctypes.c_float, _I, _I, _P], _I)
_DKV_ARGS = ([_P] * 10 + [_I] * 4 + [ctypes.c_float, _I, _I, _P], _I)
_BWD_PROTOTYPES = {
    route: {f"dl4j_{route}_dq": _DQ_ARGS, f"dl4j_{route}_dkv": _DKV_ARGS,
            "dl4j_cuda_error_string": ([_I], ctypes.c_char_p)}
    for route in ("flash_bwd", "flash_bwd_sm90")
}
# x, out, rows, width, stream
_BWD_PROTOTYPES["flash_bwd"]["dl4j_column_broadcast"] = (
    [_P, _P, ctypes.c_longlong, _I, _P], _I)


def _check_kernel_type(dtype: torch.dtype, D: int) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes float32 or bfloat16, got {dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {D}")


def _kernel_operands(tensors, lens, kmask, who: str):
    """Checked, contiguous operands of a flash kernel: ``tensors`` share a
    CUDA device, a dtype (f32 or bf16) and a (BH, T, D) shape with a head
    dim the kernels take; lens/kmask become int32/int8 on that device."""
    q = tensors[0]
    if not all(a.is_cuda for a in tensors):
        raise ValueError(f"{who} takes CUDA tensors")
    _check_kernel_type(q.dtype, q.shape[-1])
    if any(a.dtype != q.dtype for a in tensors):
        raise ValueError("q, k and v must share one dtype")
    if any(a.shape != q.shape for a in tensors):
        raise ValueError(f"{who}: operand shapes differ from q's "
                         f"{tuple(q.shape)}")
    tensors = [a.contiguous() for a in tensors]
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError("flash kernel needs 16-byte aligned operands")
    dev = q.device
    if lens is not None:
        lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    if kmask is not None:
        kmask = kmask.to(device=dev, dtype=torch.int8).contiguous()
    return tensors, lens, kmask


def _fwd_route(dtype: torch.dtype, D: int) -> str:
    """The K1 kernel source that takes a forward of ``dtype`` at head dim
    ``D``: ``"flash_fwd_sm90"`` (TMA, wgmma) for bf16 at D 64 and 128,
    ``"flash_fwd"`` for f32 and for bf16 at D 16 and 32. Raises on a dtype
    or head dim no kernel takes."""
    _check_kernel_type(dtype, D)
    if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS:
        return "flash_fwd_sm90"
    return "flash_fwd"


def _bwd_route(dtype: torch.dtype, D: int) -> str:
    """The K2/K3 kernel source that takes a backward of ``dtype`` at head
    dim ``D``: ``"flash_bwd_sm90"`` (TMA, wgmma) for bf16 at D 64,
    ``"flash_bwd"`` for f32 and for bf16 at D 16, 32 and 128. Raises on a
    dtype or head dim no kernel takes."""
    _check_kernel_type(dtype, D)
    if dtype == torch.bfloat16 and D in SM90_BWD_HEAD_DIMS:
        return "flash_bwd_sm90"
    return "flash_bwd"


def flash_fwd_cuda(q, k, v, lens=None, kmask=None, *, scale: float,
                   causal: bool = False,
                   window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA flash forward (K1) on (BH, T, D) CUDA tensors;
    returns ``(o, lse)``. bf16 runs on the tensor cores (wgmma at D 64 and
    128, mma.sync below), f32 on the CUDA cores; :func:`_fwd_route` picks
    the source. A bare forward: it records no gradient
    (:func:`flash_attention` does). ``flash_fwd_cuda.launches`` counts the
    launches of either source."""
    (q, k, v), lens, kmask = _kernel_operands((q, k, v), lens, kmask,
                                              "flash_fwd_cuda")
    BH, T, D = q.shape
    route = _fwd_route(q.dtype, D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    from ..kernels import _build

    lib = _build.load(route, _FWD_PROTOTYPES[route])
    _build.launch(lib, f"dl4j_{route}",
                  (q, k, v, lens, kmask, o, lse, BH, T, D,
                   1 if q.dtype == torch.bfloat16 else 0, float(scale),
                   1 if causal else 0, int(window)),
                  "flash forward", flash_fwd_cuda)
    return o, lse


flash_fwd_cuda.launches = 0


def _bwd_operands(q, k, v, do, lse, delta, lens, kmask, who):
    (q, k, v, do), lens, kmask = _kernel_operands((q, k, v, do), lens, kmask,
                                                  who)
    BH, T, _ = q.shape
    stats = []
    for name, a in (("lse", lse), ("delta", delta)):
        if tuple(a.shape) != (BH, T) or a.dtype != torch.float32 \
                or a.device != q.device:
            raise ValueError(f"{who}: {name} must be ({BH}, {T}) float32 on "
                             f"{q.device}")
        stats.append(a.contiguous())
    return (q, k, v, do), stats, lens, kmask


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, lens=None, kmask=None, *,
                      scale: float, causal: bool = False,
                      window: int = 0) -> torch.Tensor:
    """Launch K2, the dQ pass of the CUDA flash backward, on (BH, T, D)
    CUDA tensors with the forward's ``lse`` and ``delta = rowsum(do * o)``
    ((BH, T) f32); returns dq in q's dtype. :func:`_bwd_route` picks the
    source; ``.launches`` counts the launches of either."""
    (q, k, v, do), (lse, delta), lens, kmask = _bwd_operands(
        q, k, v, do, lse, delta, lens, kmask, "flash_bwd_dq_cuda")
    BH, T, D = q.shape
    route = _bwd_route(q.dtype, D)
    dq = torch.empty_like(q)
    from ..kernels import _build

    lib = _build.load(route, _BWD_PROTOTYPES[route])
    _build.launch(lib, f"dl4j_{route}_dq",
                  (q, k, v, do, lse, delta, lens, kmask, dq, BH, T, D,
                   1 if q.dtype == torch.bfloat16 else 0, float(scale),
                   1 if causal else 0, int(window)), "flash backward dQ",
                  flash_bwd_dq_cuda)
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, lens=None, kmask=None, *,
                       scale: float, causal: bool = False,
                       window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3, the dK/dV pass of the CUDA flash backward; arguments and
    route as :func:`flash_bwd_dq_cuda`. Returns ``(dk, dv)``; a key wholly
    past its example's length gets exactly 0. ``.launches`` counts the
    launches of either source."""
    (q, k, v, do), (lse, delta), lens, kmask = _bwd_operands(
        q, k, v, do, lse, delta, lens, kmask, "flash_bwd_dkv_cuda")
    BH, T, D = q.shape
    route = _bwd_route(q.dtype, D)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    from ..kernels import _build

    lib = _build.load(route, _BWD_PROTOTYPES[route])
    _build.launch(lib, f"dl4j_{route}_dkv",
                  (q, k, v, do, lse, delta, lens, kmask, dk, dv, BH, T, D,
                   1 if q.dtype == torch.bfloat16 else 0, float(scale),
                   1 if causal else 0, int(window)), "flash backward dK/dV",
                  flash_bwd_dkv_cuda)
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_cuda(q, k, v, do, lse, delta, lens=None, kmask=None, *,
                   scale: float, causal: bool = False,
                   window: int = 0) -> Tuple[torch.Tensor, ...]:
    """K2 then K3: ``(dq, dk, dv)`` of the CUDA flash backward."""
    kw = dict(scale=scale, causal=causal, window=window)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, lens, kmask, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, lens, kmask, **kw)
    return dq, dk, dv


def column_broadcast_cuda(x: torch.Tensor, width: int) -> torch.Tensor:
    """K5: a (..., rows, 1) f32 CUDA column broadcast to (..., rows,
    width) by a kernel — the probe of the backward's (rows, 1) lse/delta
    column loads that the reference checked on its TPU
    (``scripts/debug_flashbwd.py``). Bit-equal to ``x.expand``.
    ``.launches`` counts the launches."""
    if not x.is_cuda or x.dtype != torch.float32 or x.shape[-1] != 1:
        raise ValueError("column_broadcast_cuda takes a (..., rows, 1) "
                         "float32 CUDA tensor")
    x = x.contiguous()
    out = torch.empty(x.shape[:-1] + (int(width),), dtype=x.dtype,
                      device=x.device)
    from ..kernels import _build

    lib = _build.load("flash_bwd", _BWD_PROTOTYPES["flash_bwd"])
    _build.launch(lib, "dl4j_column_broadcast",
                  (x, out, x.numel(), int(width)), "column broadcast",
                  column_broadcast_cuda)
    return out


column_broadcast_cuda.launches = 0


def _on_cpu(q) -> bool:
    """True for a CPU tensor (plain versions), False for CUDA (kernels);
    any other device is refused."""
    if q.is_cuda:
        return False
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return True


class _FlashAttention(torch.autograd.Function):
    """Flash attention on (BH, T, D) with its flash backward: K1 forward,
    K2 + K3 backward on CUDA tensors; the plain versions on CPU tensors.
    Saves (q, k, v, o, lse); returns ``(o, lse)`` with lse not
    differentiable. ``delta = rowsum(do * o)`` is taken in f32 with torch
    ops, outside the kernels, as the reference takes it."""

    @staticmethod
    def forward(ctx, q, k, v, lens, kmask, scale, causal, window):
        fwd = flash_attention_reference if _on_cpu(q) else flash_fwd_cuda
        o, lse = fwd(q, k, v, lens, kmask, scale=scale, causal=causal,
                     window=window)
        ctx.save_for_backward(q, k, v, o, lse, lens, kmask)
        ctx.args = dict(scale=scale, causal=causal, window=window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, lens, kmask = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        bwd = (flash_attention_backward_reference if _on_cpu(q)
               else flash_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, do, lse, delta, lens, kmask, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, lengths=None,
                    key_mask=None, window: Optional[int] = None):
    """Exact attention without a (T, T) score tensor in device memory.
    q, k, v: (B, T, H, D); returns (B, T, H, D) in q's dtype.
    Differentiable in q, k and v (flash backward).

    ``lengths`` ((B,) int): right-padded batches — keys at positions
    >= lengths[b] are masked; clipped to [0, T], and length 0 outputs 0.
    ``key_mask`` ((B, T) bool/int): exact arbitrary key mask; exclusive
    with ``lengths``. ``window`` (causal only): query t attends keys
    [t-window+1, t]; window >= T is plain causal."""
    B, T, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes must match, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if lengths is not None and key_mask is not None:
        raise ValueError("pass lengths OR key_mask, not both")
    if window is not None:
        if not causal:
            raise ValueError("window= requires causal=True (sliding-window "
                             "attention is a causal-LM construct)")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= T:
            window = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=q.device)
        if tuple(lengths.shape) != (B,):
            raise ValueError(f"lengths must be ({B},), got "
                             f"{tuple(lengths.shape)}")
        lengths = torch.clamp(lengths.to(torch.int32), 0, T)
    if key_mask is not None:
        key_mask = torch.as_tensor(key_mask, device=q.device)
        if tuple(key_mask.shape) != (B, T):
            raise ValueError(f"key_mask must be ({B}, {T}), got "
                             f"{tuple(key_mask.shape)}")
        key_mask = key_mask.to(torch.int8)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    _on_cpu(q)

    def to_bh(a):
        return a.permute(0, 2, 1, 3).reshape(B * H, T, D)

    # each example's lengths or key mask for its H heads: an expand and a
    # copy, whose size is known on the host (no sync, so a CUDA graph can
    # capture it)
    lens_bh = None if lengths is None else \
        lengths[:, None].expand(B, H).reshape(B * H)
    km_bh = None if key_mask is None else \
        key_mask[:, None].expand(B, H, T).reshape(B * H, T)
    o, _ = _FlashAttention.apply(to_bh(q), to_bh(k), to_bh(v), lens_bh, km_bh,
                                 scale, causal, window or 0)
    return o.reshape(B, H, T, D).permute(0, 2, 1, 3)
