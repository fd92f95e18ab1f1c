"""Custom layers — counterpart of ``deeplearning4j_tpu/nn/layers/custom.py``:
``Lambda`` (no params) and ``CustomLayer`` (params from an init
function), each naming its functions by import path (``"pkg.mod:fn"``), so
a saved config reloads wherever the code is importable. A config names
functions of its own package: the port's functions take and return
tensors, and autograd differentiates them as it does the built-in
layers.
"""

from __future__ import annotations

import importlib
import inspect
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch

from ..api import Layer, Shape, register_layer


def resolve_function(path: str):
    """Import ``"package.module:attr"`` (dotted attrs allowed)."""
    if ":" not in path:
        raise ValueError(f"Function reference must be 'module:attr', got "
                         f"{path!r}")
    mod, _, attr = path.partition(":")
    fn = importlib.import_module(mod)
    for part in attr.split("."):
        fn = getattr(fn, part)
    return fn


@register_layer
@dataclass(frozen=True)
class Lambda(Layer):
    """A param-less custom layer (SameDiffLambdaLayer): ``fn`` is the path
    of ``f(x, **config) -> y``; ``out_shape`` the output feature shape
    when it differs from the input's."""

    _HAS_PARAMS = False

    fn: str = ""
    config: Optional[Dict[str, Any]] = None
    out_shape: Optional[Sequence[int]] = None

    def output_shape(self, input_shape: Shape) -> Shape:
        return (tuple(self.out_shape) if self.out_shape is not None
                else input_shape)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        return resolve_function(self.fn)(x, **(self.config or {})), state, mask


def _to(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to(v, dtype, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(dtype=dtype, device=device)


@register_layer
@dataclass(frozen=True)
class CustomLayer(Layer):
    """A custom layer with params (BaseSameDiffLayer): ``init_fn`` is the
    path of ``f(gen, input_shape, **config) -> params`` (a dict of arrays
    or tensors, cast to the model's dtype and device), ``fn`` the path of
    ``f(params, x, *, training, rng, **config) -> y`` (``training`` and
    ``rng`` passed only when ``f`` takes them, by name or ``**kwargs``)."""

    fn: str = ""
    init_fn: str = ""
    config: Optional[Dict[str, Any]] = None
    out_shape: Optional[Sequence[int]] = None

    def output_shape(self, input_shape: Shape) -> Shape:
        return (tuple(self.out_shape) if self.out_shape is not None
                else input_shape)

    def init(self, gen, input_shape, dtype=torch.float32, device=None):
        params = resolve_function(self.init_fn)(gen, tuple(input_shape),
                                                **(self.config or {}))
        return _to(params, dtype, device), {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        f = resolve_function(self.fn)
        kw = dict(self.config or {})
        sig = inspect.signature(f)
        var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
        if var_kw or "training" in sig.parameters:
            kw["training"] = training
        if var_kw or "rng" in sig.parameters:
            kw["rng"] = rng
        return f(params, x, **kw), state, mask
