"""Weight initialization by scheme name — counterpart of
``deeplearning4j_tpu/ops/initializers.py``.

Each scheme draws from an explicit ``torch.Generator`` on the target device;
the port carries ``xavier`` (dense layers) and ``relu`` (He normal, the
conv layers' default). JAX's random bits cannot be reproduced, so a port
model built from a seed
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


@register("xavier")
def xavier(gen, shape, fan_in, fan_out, dtype, device):
    # Glorot normal: variance 2/(fan_in+fan_out)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


@register("relu")
def relu_init(gen, shape, fan_in, fan_out, dtype, device):
    # He normal: variance 2/fan_in
    std = math.sqrt(2.0 / fan_in)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def init_param(gen: Optional[torch.Generator], scheme, shape, *,
               kind: str = "dense", dtype=torch.float32, device=None,
               fan_in: Optional[int] = None,
               fan_out: Optional[int] = None) -> torch.Tensor:
    """One parameter tensor from a named scheme, drawn from ``gen``."""
    fi, fo = compute_fans(shape, kind)
    return get(scheme)(gen, tuple(shape), fan_in or fi, fan_out or fo,
                       dtype, device)
