"""BatchNorm's backward: the BN-reduce kernels K4a and K4b and the
autograd Function that runs them.

Counterpart of ``scripts/bn_reduce_bench.py:28-82`` (``bn_bwd_xla``,
``bn_bwd_pallas``) and of the gradient of the single-pass training
``BatchNorm`` in ``deeplearning4j_tpu/nn/layers/norm.py:46-78``.

- :func:`bn_reduce` (K4a, ``kernels/csrc/bn_bwd.cu``): per-channel f32
  ``(Σdy, Σdy·x)`` over a row-major (M, C) pair in f32 or bf16, in one
  launch, on the bulk route where C is a multiple of 16 bytes and x and
  dy are 16-byte aligned (:func:`_vectors_fit`), else the scalar route.
- :func:`bn_reduce_coeffs`: K4a's fused mode, which also computes the
  per-channel algebra of the backward (:func:`bn_backward_coeffs_reference`)
  in the same launch.
- :func:`bn_dx` (K4b): ``dx = dy·a + c1 + x·c2`` elementwise with
  per-channel ``a``, ``c1``, ``c2``, in x's dtype, rounding as bf16
  arithmetic does: ``dy·a``, ``c1`` and ``x·c2`` each rounded to x's
  dtype, then summed left to right with a rounding after each add.
- :func:`bn_bwd`: the script's composition, ``c1 = Σdy/M``,
  ``c2 = 2·Σdy·x/M``, both rounded to x's dtype.
- :func:`bn_backward`: a training BatchNorm's backward, on the card the
  fused K4a and then K4b: two launches.

On a CUDA tensor each wrapper launches its kernel (a failed build or
launch raises; there is no fallback) and counts the launch in
``.launches`` and the route in ``.routes``; on a CPU tensor it runs the
plain PyTorch version beside it (:func:`bn_reduce_reference`,
:func:`bn_dx_reference`, :func:`bn_backward_reference`), which the tests
hold against the script and the kernels are held against on the card.

:func:`batch_norm_train` is training-mode BatchNorm on (M, C) through
``_BatchNormFunction``. Its forward is the reference's, op for op: f32
``mean`` and ``msq = mean(x²)``, ``var = max(msq − mean², 0)``,
``inv = rsqrt(var + eps)``, ``a = inv·γ``, ``b = β − mean·a``, and
``y = x·a + b`` with ``a`` and ``b`` cast to x's dtype (two roundings in
bf16). It saves ``x`` and per-channel f32 statistics only. Its backward,
given ``dy``::

    S1, S2 = K4a(x, dy), rounded to x's dtype (where the reference's
             cotangents of the bf16 a and b arrive)
    dβ = S1;  dA = S2 − mean·S1;  dγ = dA·inv
    dvar = dA·γ·(−½·inv/(var + eps))           (rsqrt's JVP)
    dmsq = dvar·w, w = 1 where msq − mean² > 0, ½ where it is 0 (the
           balanced JVP of max), 0 below
    dmean = −a·S1 − 2·mean·dmsq
    dx = K4b(x, dy, a in x's dtype, c1 = dmean/M, c2 = 2·dmsq/M)
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PROTOTYPES = {
    # x, dy, sums, ws, ws_bytes, M, C, is_bf16, bulk, mean, var, inv, a,
    # gap, gamma, gamma_bf16, eps, coef, dgamma, dbeta, stream
    "dl4j_bn_reduce": ([_P] * 4 + [_L, _L, _I, _I, _I] + [_P] * 6
                       + [_I, ctypes.c_double] + [_P] * 4, _I),
    # x, dy, a, c1, c2, dx, M, C, is_bf16, vector, stream
    "dl4j_bn_dx": ([_P] * 6 + [_L, _I, _I, _I, _P], _I),
    "dl4j_cuda_error_string": ([_I], ctypes.c_char_p),
}


def bn_reduce_reference(x: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4a: f32 ``(Σdy, Σdy·x)`` over the rows of (M, C) ``x``,
    ``dy``, the products taken in f32 (as the Pallas kernel takes them)."""
    dyf = dy.float()
    return dyf.sum(dim=0), (dyf * x.float()).sum(dim=0)


def bn_dx_reference(x, dy, a, c1, c2) -> torch.Tensor:
    """Plain K4b: ``dy·a + c1 + x·c2`` over (M, C) in x's dtype, with
    (C,) ``a``, ``c1``, ``c2`` taken as f32 and each term rounded to x's
    dtype before the two adds."""
    dt = x.dtype
    t1 = (dy.float() * a.float()).to(dt)
    t3 = (x.float() * c2.float()).to(dt)
    return t1 + c1.float().to(dt) + t3


def bn_backward_coeffs_reference(s1, s2, mean, var, inv, a, gap, gamma,
                                 eps: float, M: int, dtype: torch.dtype):
    """The per-channel algebra between K4a and K4b, op for op: from the f32
    sums ``s1 = Σdy``, ``s2 = Σdy·x`` and the forward's saved (C,) f32
    ``mean``, ``var``, ``inv``, ``a``, ``gap`` (``gamma`` (C,) or None),
    returns ``(coef, dgamma, dbeta)``: ``coef`` (3, C) f32 holds K4b's
    operands (``a`` rounded to x's ``dtype``, ``c1 = dmean/M``,
    ``c2 = 2·(dmsq/M)``), ``dgamma`` and ``dbeta`` are in gamma's dtype
    (None without gamma). The fused K4a computes the same bits. Each
    division is by a tensor of M, so it is IEEE division on every device
    (a CUDA tensor divided by a Python scalar multiplies by its
    reciprocal)."""
    s1 = s1.to(dtype).float()
    s2 = s2.to(dtype).float()
    d_a = s2 - mean * s1
    d_inv = d_a if gamma is None else d_a * gamma.float()
    dvar = d_inv * (-0.5 * inv / (var + eps))
    w = torch.where(gap > 0, 1.0, torch.where(gap == 0, 0.5, 0.0))
    dmsq = dvar * w
    dmean = -a * s1 - 2.0 * mean * dmsq
    m = torch.full_like(dmean, M)
    coef = torch.stack((a.to(dtype).float(), dmean / m, 2.0 * (dmsq / m)))
    if gamma is None:
        return coef, None, None
    return coef, (d_a * inv).to(gamma.dtype), s1.to(gamma.dtype)


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (plain versions), False for CUDA tensors on
    one device (kernels); anything else is refused."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"BN kernels take CPU tensors or CUDA tensors on one "
                     f"device, got {[str(t.device) for t in tensors]}")


def _rows(x: torch.Tensor, dy: torch.Tensor, who: str) -> Tuple[int, int]:
    """Check (M, C) operands of a BN kernel; returns (M, C)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise ValueError(f"{who} takes float32 or bfloat16 x and dy of one "
                         f"dtype, got {x.dtype} and {dy.dtype}")
    if x.ndim != 2 or dy.shape != x.shape:
        raise ValueError(f"{who} takes (M, C) x and dy of one shape, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"{who} takes contiguous row-major (M, C) tensors "
                         f"(a strided view is refused, not copied)")
    return x.shape


def _lib():
    from ..kernels import _build

    return _build, _build.load("bn_bwd", _PROTOTYPES)


def _vectors_fit(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True where a row of (M, C) ``x`` is a whole number of 16-byte
    vectors and ``x`` and every other tensor start on a 16-byte boundary:
    K4a's bulk route and K4b's vector route; anything else takes the
    scalar route."""
    return x.shape[-1] * x.element_size() % 16 == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (x, *others))


_ws_lock = threading.Lock()
_workspace: Dict[tuple, torch.Tensor] = {}


def _workspace_bytes(C: int, sms: int) -> int:
    """Workspace bytes that every K4a grid on a card of ``sms`` SMs fits
    in (``dl4j_bn_reduce`` checks its plan against it): the 65,536 ticket
    counters, then two (parts + groups, C) f32 planes of partials, with
    parts·C at most max(C, 8 CTAs a SM · SMs · 512 channels a chunk)."""
    return 4 * 65536 + 16 * max(C, 8 * sms * 512)


def _reduce_workspace(device, stream: int, nbytes: int) -> torch.Tensor:
    """The K4a workspace of ``device`` and ``stream`` (a raw stream
    handle), of at least ``nbytes``. Its head holds the kernel's ticket
    counters, zero at allocation and left zero by every launch, so it is
    cached and grown, never cleared. Launches on one stream run one after
    another; a workspace of its own for each stream keeps launches on two
    streams from drawing each other's tickets."""
    key = (torch.device(device), stream)
    with _ws_lock:
        ws = _workspace.get(key)
        if ws is None or ws.numel() * 4 < nbytes:
            ws = _workspace[key] = torch.zeros(
                (nbytes + 3) // 4, dtype=torch.int32, device=device)
        return ws


def _reduce(x, dy, who, wrapper, stats=None):
    """Launch K4a: the sums mode, or with ``stats`` (mean, var, inv, a,
    gap, gamma, eps) the fused mode. Returns the (2, C) sums, or (coef,
    dgamma, dbeta) in the fused mode."""
    M, C = _rows(x, dy, who)
    bf16 = 1 if x.dtype == torch.bfloat16 else 0
    bulk = _vectors_fit(x, dy)
    build, lib = _lib()
    # the stream that build.launch launches on
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ws = _reduce_workspace(x.device, stream, _workspace_bytes(C, sms))
    # mean, var, inv, a, gap, gamma, gamma is bf16, eps; coef, dgamma, dbeta
    fused, outs, sums = [None] * 6 + [0, 0.0], [None] * 3, None
    if stats is None:
        sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    else:
        *per_channel, gamma, eps = stats
        per_channel = [t.to(device=x.device, dtype=torch.float32).contiguous()
                       for t in per_channel]
        if any(tuple(t.shape) != (C,) for t in per_channel):
            raise ValueError(f"{who}: mean, var, inv, a and gap must be ({C},)")
        outs[0] = torch.empty((3, C), dtype=torch.float32, device=x.device)
        if gamma is not None:
            if gamma.dtype not in (torch.float32, torch.bfloat16) \
                    or tuple(gamma.shape) != (C,):
                raise ValueError(f"{who}: gamma must be ({C},) float32 or "
                                 f"bfloat16")
            gamma = gamma.to(x.device).contiguous()
            outs[1:] = torch.empty_like(gamma), torch.empty_like(gamma)
        fused = per_channel + [gamma, int(gamma is not None and
                                          gamma.dtype == torch.bfloat16),
                               float(eps)]
    build.launch(lib, "dl4j_bn_reduce",
                 (x, dy, sums, ws, ws.numel() * 4, M, C, bf16, int(bulk),
                  *fused, *outs), who, wrapper)
    wrapper.routes["bulk" if bulk else "scalar"] += 1
    return sums if stats is None else tuple(outs)


def bn_reduce(x: torch.Tensor, dy: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a: per-channel f32 ``(Σdy, Σdy·x)`` over the rows of (M, C)
    ``x`` and ``dy`` (f32 or bf16, contiguous), in one launch on the bulk
    or the scalar route (:func:`_vectors_fit`). Deterministic: partial
    sums per CTA folded in a fixed order through integer tickets, no float
    atomics. ``.launches`` counts the kernel launches, ``.routes`` the
    launches per route."""
    if _on_cpu(x, dy):
        return bn_reduce_reference(x, dy)
    out = _reduce(x, dy, "BN reduce (K4a)", bn_reduce)
    return out[0], out[1]


bn_reduce.launches = 0
bn_reduce.routes = {"bulk": 0, "scalar": 0}


def bn_reduce_coeffs(x, dy, mean, var, inv, a, gap, gamma, eps: float):
    """K4a's fused mode: in one launch, the sums of :func:`bn_reduce` (the
    same grid, so the same bits) and :func:`bn_backward_coeffs_reference`'s
    outputs from them, bit for bit. Returns ``(coef, dgamma, dbeta)``:
    ``coef`` (3, C) f32 holds a in x's dtype, c1, c2; ``dgamma``, ``dbeta``
    are in gamma's dtype, or None without gamma. ``.launches`` and
    ``.routes`` count as :func:`bn_reduce`'s do."""
    if _on_cpu(x, dy):
        s1, s2 = bn_reduce_reference(x, dy)
        return bn_backward_coeffs_reference(s1, s2, mean, var, inv, a, gap,
                                            gamma, eps, x.shape[0], x.dtype)
    return _reduce(x, dy, "BN reduce, fused (K4a)", bn_reduce_coeffs,
                   (mean, var, inv, a, gap, gamma, eps))


bn_reduce_coeffs.launches = 0
bn_reduce_coeffs.routes = {"bulk": 0, "scalar": 0}


def bn_dx(x, dy, a, c1, c2) -> torch.Tensor:
    """K4b: ``dx = dy·a + c1 + x·c2`` over (M, C) ``x``, ``dy`` (f32 or
    bf16, contiguous) with (C,) ``a``, ``c1``, ``c2`` (any float dtype,
    taken as f32; f32 contiguous ones are used as they are); dx in x's
    dtype, rounded as :func:`bn_dx_reference`. ``.launches`` counts the
    kernel launches, ``.routes`` those on 16-byte vectors and on one
    element a lane."""
    if _on_cpu(x, dy):
        return bn_dx_reference(x, dy, a, c1, c2)
    M, C = _rows(x, dy, "bn_dx")
    per_channel = [t.to(device=x.device, dtype=torch.float32).contiguous()
                   for t in (a, c1, c2)]
    if any(tuple(t.shape) != (C,) for t in per_channel):
        raise ValueError(f"bn_dx: a, c1 and c2 must be ({C},)")
    build, lib = _lib()
    dx = torch.empty_like(x)
    bf16 = x.dtype == torch.bfloat16
    vector = _vectors_fit(x, dy, dx, *per_channel)
    build.launch(lib, "dl4j_bn_dx", (x, dy, *per_channel, dx, M, C, int(bf16),
                                     int(vector)),
                 "BN dx (K4b)", bn_dx)
    bn_dx.routes["vector" if vector else "scalar"] += 1
    return dx


bn_dx.launches = 0
bn_dx.routes = {"vector": 0, "scalar": 0}


def _bwd(x, dy, a, reduce, dx_fn) -> torch.Tensor:
    M = x.shape[0]
    s_dy, s_dyx = reduce(x, dy)
    c1 = (s_dy * (1.0 / M)).to(x.dtype)
    c2 = (s_dyx * (2.0 / M)).to(x.dtype)
    return dx_fn(x, dy, a, c1, c2)


def bn_bwd(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The script's BN-backward-style pass (``bn_bwd_pallas``): K4a, then
    ``c1 = Σdy·(1/M)`` and ``c2 = Σdy·x·(2/M)`` rounded to x's dtype, then
    K4b with per-channel ``a``."""
    return _bwd(x, dy, a, bn_reduce, bn_dx)


def bn_bwd_reference(x, dy, a) -> torch.Tensor:
    """:func:`bn_bwd` with the plain versions of K4a and K4b."""
    return _bwd(x, dy, a, bn_reduce_reference, bn_dx_reference)


def bn_backward_reference(x, dy, gamma, mean, var, inv, a, gap, eps):
    """A training BatchNorm's backward with the plain versions: K4a's sums,
    the per-channel algebra, K4b. Returns ``(dx, dgamma, dbeta)``."""
    s1, s2 = bn_reduce_reference(x, dy)
    coef, dgamma, dbeta = bn_backward_coeffs_reference(
        s1, s2, mean, var, inv, a, gap, gamma, eps, x.shape[0], x.dtype)
    return bn_dx_reference(x, dy, *coef), dgamma, dbeta


def bn_backward(x, dy, gamma, mean, var, inv, a, gap, eps):
    """A training BatchNorm's backward from the forward's saved tensors:
    on the card the fused K4a (sums and per-channel algebra) and K4b, two
    launches with no op between them; on the CPU
    :func:`bn_backward_reference`. Returns ``(dx, dgamma, dbeta)``."""
    if _on_cpu(x, dy):
        return bn_backward_reference(x, dy, gamma, mean, var, inv, a, gap,
                                     eps)
    coef, dgamma, dbeta = bn_reduce_coeffs(x, dy, mean, var, inv, a, gap,
                                           gamma, eps)
    return bn_dx(x, dy, coef[0], coef[1], coef[2]), dgamma, dbeta


class _BatchNormFunction(torch.autograd.Function):
    """Training-mode BatchNorm on contiguous (M, C) ``x``: returns
    ``(y, mean, var)``, mean and var f32 and not differentiable. ``gamma``
    and ``beta`` are (C,) or both None (lock_gamma_beta). Saves ``x`` and
    (C,) f32 statistics; the backward is :func:`bn_backward`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        xf = x.float()
        mean = xf.mean(dim=0)
        msq = (xf * xf).mean(dim=0)
        del xf
        gap = msq - mean * mean
        var = torch.clamp(gap, min=0.0)
        inv = torch.rsqrt(var + eps)
        if gamma is None:
            a = inv
            b = -mean * inv
        else:
            a = inv * gamma.float()
            b = beta.float() - mean * a
        y = x * a.to(x.dtype) + b.to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, var, inv, a, gap)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        # mean and var take no gradient: leave their (C,) zeros unmade
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, var, inv, a, gap = ctx.saved_tensors
        if dy is None:
            return None, None, None, None
        dx, dgamma, dbeta = bn_backward(x, dy.contiguous(), gamma, mean, var,
                                        inv, a, gap, ctx.eps)
        return dx, dgamma, dbeta, None


def batch_norm_train(x: torch.Tensor, gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor], eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm over the rows of contiguous (M, C) ``x``:
    ``(y, batch mean, batch var)`` with the K4a/K4b backward."""
    return _BatchNormFunction.apply(x, gamma, beta, float(eps))
