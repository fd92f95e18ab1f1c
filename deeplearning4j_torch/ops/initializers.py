"""Weight initialization by scheme name — counterpart of
``deeplearning4j_tpu/ops/initializers.py``.

Each scheme is a function ``(gen, shape, fan_in, fan_out, dtype, device)
-> Tensor`` that draws from an explicit ``torch.Generator`` on the target
device; the registry holds the reference's fifteen named schemes and its
six ``var_scaling_{fan_in,fan_out,fan_avg}_{normal,uniform}`` variants,
and :func:`distribution` makes a parameterized one. JAX's random bits
cannot be reproduced, so a port model built from a seed
has other weights than the reference's from the same seed; parity tests
carry the reference's params across instead, and init is checked by its
distribution.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown weight init '{name_or_fn}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)


def compute_fans(shape: Sequence[int], kind: str = "dense"):
    """fan_in/fan_out: dense (in, out) -> (in, out); conv HWIO
    (kh, kw, in, out) -> (kh*kw*in, kh*kw*out). ``kind`` names the layout
    as the reference's argument does; both follow from the shape."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return receptive * shape[-2], receptive * shape[-1]


def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _uniform(gen, shape, a, b, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        a, b, generator=gen)


def _zeros(gen, shape, fan_in, fan_out, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


register("zero")(_zeros)
register("zeros")(_zeros)


@register("ones")
def ones(gen, shape, fan_in, fan_out, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


@register("normal")
def normal(gen, shape, fan_in, fan_out, dtype, device):
    # DL4J NORMAL: N(0, 1/sqrt(fan_in)), a std, not a variance
    return _normal(gen, shape, dtype, device) / math.sqrt(fan_in)


@register("uniform")
def uniform(gen, shape, fan_in, fan_out, dtype, device):
    a = math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, -a, a, dtype, device)


@register("xavier")
def xavier(gen, shape, fan_in, fan_out, dtype, device):
    # Glorot normal: variance 2/(fan_in+fan_out)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return _normal(gen, shape, dtype, device) * std


@register("xavier_uniform")
def xavier_uniform(gen, shape, fan_in, fan_out, dtype, device):
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype, device)


@register("xavier_fan_in")
def xavier_fan_in(gen, shape, fan_in, fan_out, dtype, device):
    return _normal(gen, shape, dtype, device) * math.sqrt(1.0 / fan_in)


@register("xavier_legacy")
def xavier_legacy(gen, shape, fan_in, fan_out, dtype, device):
    # DL4J's historical variant: variance 1/(fan_in+fan_out)
    std = math.sqrt(1.0 / (fan_in + fan_out))
    return _normal(gen, shape, dtype, device) * std


@register("relu")
def relu_init(gen, shape, fan_in, fan_out, dtype, device):
    # He normal: variance 2/fan_in
    return _normal(gen, shape, dtype, device) * math.sqrt(2.0 / fan_in)


@register("relu_uniform")
def relu_uniform(gen, shape, fan_in, fan_out, dtype, device):
    a = math.sqrt(6.0 / fan_in)
    return _uniform(gen, shape, -a, a, dtype, device)


@register("lecun_normal")
def lecun_normal(gen, shape, fan_in, fan_out, dtype, device):
    return _normal(gen, shape, dtype, device) * math.sqrt(1.0 / fan_in)


@register("lecun_uniform")
def lecun_uniform(gen, shape, fan_in, fan_out, dtype, device):
    a = math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, -a, a, dtype, device)


@register("sigmoid_uniform")
def sigmoid_uniform(gen, shape, fan_in, fan_out, dtype, device):
    a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype, device)


@register("identity")
def identity_init(gen, shape, fan_in, fan_out, dtype, device):
    if len(shape) == 2 and shape[0] == shape[1]:
        return torch.eye(shape[0], dtype=dtype, device=device)
    # conv identity: a delta kernel at the spatial centre
    if len(shape) >= 3 and shape[-2] == shape[-1]:
        w = torch.zeros(shape, dtype=dtype, device=device)
        w[tuple(s // 2 for s in shape[:-2])] = torch.eye(
            shape[-1], dtype=dtype, device=device)
        return w
    raise ValueError(f"IDENTITY init requires square weights, got {shape}")


def _var_scaling(gen, shape, scale_mode, distribution, fan_in, fan_out,
                 dtype, device):
    if scale_mode == "fan_in":
        n = fan_in
    elif scale_mode == "fan_out":
        n = fan_out
    else:
        n = (fan_in + fan_out) / 2.0
    if distribution == "normal":
        return _normal(gen, shape, dtype, device) * math.sqrt(1.0 / n)
    a = math.sqrt(3.0 / n)
    return _uniform(gen, shape, -a, a, dtype, device)


for _mode in ("fan_in", "fan_out", "fan_avg"):
    for _dist in ("normal", "uniform"):
        def _make(mode=_mode, dist=_dist):
            def fn(gen, shape, fan_in, fan_out, dtype, device):
                return _var_scaling(gen, shape, mode, dist, fan_in, fan_out,
                                    dtype, device)

            return fn

        register(f"var_scaling_{_mode}_{_dist}")(_make())


def _truncated_normal(gen, shape, dtype, device):
    """Standard normal truncated to [-2, 2], by the inverse CDF of a
    uniform draw in f32 (as ``jax.random.truncated_normal`` draws it)."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = _uniform(gen, shape, 2.0 * lo - 1.0, 2.0 * hi - 1.0, torch.float32,
                 device)
    z = torch.erfinv(u) * math.sqrt(2.0)
    return torch.clamp(z, -2.0, 2.0).to(dtype)


def _orthogonal(gen, shape, gain, dtype, device):
    """``jax.nn.initializers.orthogonal(gain)``: a (prod(shape[:-1]),
    shape[-1]) matrix with orthonormal columns (rows when it is wide),
    from the QR of a normal draw in f32 with R's diagonal signs folded in,
    reshaped to ``shape``."""
    if len(shape) < 2:
        raise ValueError("orthogonal initializer requires at least a 2D "
                         "shape")
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = _normal(gen, (max(n_rows, n_cols), min(n_rows, n_cols)),
                torch.float32, device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
    if n_rows < n_cols:
        q = q.T
    return (gain * q.reshape(shape)).to(dtype)


def distribution(dist_name: str, **kwargs):
    """WeightInit.DISTRIBUTION: a scheme that draws from a parameterized
    distribution — normal/gaussian(mean, std), uniform(lower, upper),
    truncated_normal(mean, std) (at 2 std), constant(value),
    orthogonal(gain) or binomial(p)."""
    dist_name = dist_name.lower()

    def fn(gen, shape, fan_in, fan_out, dtype=torch.float32, device=None):
        if dist_name in ("normal", "gaussian"):
            return (kwargs.get("mean", 0.0)
                    + _normal(gen, shape, dtype, device) * kwargs.get("std", 1.0))
        if dist_name == "uniform":
            return _uniform(gen, shape, kwargs.get("lower", -1.0),
                            kwargs.get("upper", 1.0), dtype, device)
        if dist_name == "truncated_normal":
            return (kwargs.get("mean", 0.0)
                    + _truncated_normal(gen, shape, dtype, device)
                    * kwargs.get("std", 1.0))
        if dist_name == "constant":
            return torch.full(shape, kwargs.get("value", 0.0), dtype=dtype,
                              device=device)
        if dist_name == "orthogonal":
            return _orthogonal(gen, shape, kwargs.get("gain", 1.0), dtype,
                               device)
        if dist_name == "binomial":
            p = torch.full(shape, kwargs.get("p", 0.5), dtype=torch.float32,
                           device=device)
            return torch.bernoulli(p, generator=gen).to(dtype)
        raise ValueError(f"Unknown distribution '{dist_name}'")

    return fn


def init_param(gen: Optional[torch.Generator], scheme, shape, *,
               kind: str = "dense", dtype=torch.float32, device=None,
               fan_in: Optional[int] = None,
               fan_out: Optional[int] = None) -> torch.Tensor:
    """One parameter tensor from a named scheme (or a scheme function such
    as :func:`distribution`'s), drawn from ``gen`` on ``device``. On the
    meta device only the shape is made."""
    fi, fo = compute_fans(shape, kind)
    fn = get(scheme)
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    return fn(gen, tuple(shape), fan_in or fi, fan_out or fo, dtype, device)
