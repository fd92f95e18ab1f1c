"""BatchNorm's backward: the BN-reduce kernels K4a and K4b and the
autograd Function that runs them.

Counterpart of ``scripts/bn_reduce_bench.py:28-82`` (``bn_bwd_xla``,
``bn_bwd_pallas``) and of the gradient of the single-pass training
``BatchNorm`` in ``deeplearning4j_tpu/nn/layers/norm.py:46-78``.

- :func:`bn_reduce` (K4a, ``kernels/csrc/bn_bwd.cu``): per-channel f32
  ``(Σdy, Σdy·x)`` over a row-major (M, C) pair in f32 or bf16.
- :func:`bn_dx` (K4b): ``dx = dy·a + c1 + x·c2`` elementwise with
  per-channel ``a``, ``c1``, ``c2``, in x's dtype, rounding as bf16
  arithmetic does: ``dy·a``, ``c1`` and ``x·c2`` each rounded to x's
  dtype, then summed left to right with a rounding after each add.
- :func:`bn_bwd`: the script's composition, ``c1 = Σdy/M``,
  ``c2 = 2·Σdy·x/M``, both rounded to x's dtype.

On a CUDA tensor each wrapper launches its kernel (a failed build or
launch raises; there is no fallback) and counts the launch in
``.launches``; on a CPU tensor it runs the plain PyTorch version beside it
(:func:`bn_reduce_reference`, :func:`bn_dx_reference`), which the tests
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
from typing import Optional, Tuple

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PROTOTYPES = {
    # x, dy, M, C, is_bf16
    "dl4j_bn_reduce_workspace": ([_P, _P, _L, _I, _I], _L),
    # x, dy, out, ws, M, C, is_bf16, stream
    "dl4j_bn_reduce": ([_P] * 4 + [_L, _I, _I, _P], _I),
    # x, dy, a, c1, c2, dx, M, C, is_bf16, stream
    "dl4j_bn_dx": ([_P] * 6 + [_L, _I, _I, _P], _I),
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


def bn_reduce(x: torch.Tensor, dy: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a: per-channel f32 ``(Σdy, Σdy·x)`` over the rows of (M, C)
    ``x`` and ``dy`` (f32 or bf16, contiguous). Deterministic: partial sums
    per block folded in a fixed order, no atomics. ``.launches`` counts
    the kernel launches."""
    if _on_cpu(x, dy):
        return bn_reduce_reference(x, dy)
    M, C = _rows(x, dy, "bn_reduce")
    bf16 = 1 if x.dtype == torch.bfloat16 else 0
    build, lib = _lib()
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    ws = torch.empty(lib.dl4j_bn_reduce_workspace(x.data_ptr(), dy.data_ptr(),
                                                  M, C, bf16),
                     dtype=torch.float32, device=x.device)
    build.launch(lib, "dl4j_bn_reduce", (x, dy, out, ws, M, C, bf16),
                 "BN reduce (K4a)", bn_reduce)
    return out[0], out[1]


bn_reduce.launches = 0


def bn_dx(x, dy, a, c1, c2) -> torch.Tensor:
    """K4b: ``dx = dy·a + c1 + x·c2`` over (M, C) ``x``, ``dy`` (f32 or
    bf16, contiguous) with (C,) ``a``, ``c1``, ``c2`` (any float dtype,
    taken as f32); dx in x's dtype, rounded as :func:`bn_dx_reference`.
    ``.launches`` counts the kernel launches."""
    if _on_cpu(x, dy):
        return bn_dx_reference(x, dy, a, c1, c2)
    M, C = _rows(x, dy, "bn_dx")
    per_channel = [t.to(device=x.device, dtype=torch.float32).contiguous()
                   for t in (a, c1, c2)]
    if any(tuple(t.shape) != (C,) for t in per_channel):
        raise ValueError(f"bn_dx: a, c1 and c2 must be ({C},)")
    build, lib = _lib()
    dx = torch.empty_like(x)
    build.launch(lib, "dl4j_bn_dx", (x, dy, *per_channel, dx, M, C,
                                     1 if x.dtype == torch.bfloat16 else 0),
                 "BN dx (K4b)", bn_dx)
    return dx


bn_dx.launches = 0


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


class _BatchNormFunction(torch.autograd.Function):
    """Training-mode BatchNorm on contiguous (M, C) ``x``: returns
    ``(y, mean, var)``, mean and var f32 and not differentiable. ``gamma``
    and ``beta`` are (C,) or both None (lock_gamma_beta). Saves ``x`` and
    (C,) f32 statistics; the backward is K4a, per-channel algebra, K4b."""

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
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, var, inv, a, gap = ctx.saved_tensors
        M = x.shape[0]
        dy = dy.contiguous()
        s1, s2 = bn_reduce(x, dy)
        s1 = s1.to(x.dtype).float()
        s2 = s2.to(x.dtype).float()
        d_a = s2 - mean * s1
        d_inv = d_a if gamma is None else d_a * gamma.float()
        dvar = d_inv * (-0.5 * inv / (var + ctx.eps))
        w = torch.where(gap > 0, 1.0, torch.where(gap == 0, 0.5, 0.0))
        dmsq = dvar * w
        dmean = -a * s1 - 2.0 * mean * dmsq
        dx = bn_dx(x, dy, a.to(x.dtype), dmean / M, 2.0 * (dmsq / M))
        if gamma is None:
            return dx, None, None, None
        return dx, (d_a * inv).to(gamma.dtype), s1.to(gamma.dtype), None


def batch_norm_train(x: torch.Tensor, gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor], eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm over the rows of contiguous (M, C) ``x``:
    ``(y, batch mean, batch var)`` with the K4a/K4b backward."""
    return _BatchNormFunction.apply(x, gamma, beta, float(eps))
