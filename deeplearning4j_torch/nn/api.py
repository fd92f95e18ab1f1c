"""Layer API — counterpart of ``deeplearning4j_tpu/nn/api.py``.

A ``Layer`` is a frozen dataclass of hyperparameters with the reference's
fields, and the two functions of the contract:

- ``init(gen, input_shape, dtype, device)`` returns ``(params, state)``,
  dicts of tensors drawn from the ``torch.Generator`` ``gen``;
- ``apply(params, state, x, *, training, rng, mask)`` returns
  ``(y, new_state, out_mask)``; ``rng`` is a ``torch.Generator`` or None.
  A layer's ``dropout`` acts on its input, in training only
  (:func:`apply_input_dropout`).

``to_dict``/``layer_from_dict`` write and read the reference's ``"@type"``
JSON: a layer config written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Type

import torch

from ..ops.regularization import apply_dropout_config

Params = Dict[str, Any]
State = Dict[str, Any]
Shape = Tuple[int, ...]

LAYER_REGISTRY: Dict[str, Type["Layer"]] = {}


def register_layer(cls: Type["Layer"]) -> Type["Layer"]:
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


@dataclass(frozen=True)
class Layer:
    """Base hyperparameter record for all layers (fields as the reference's)."""

    name: Optional[str] = None
    updater: Optional[dict] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[Any] = None  # applied to the layer's input in training
    weight_init: Optional[str] = None
    constraint: Optional[Any] = None

    # False on the layers the reference marks param-less (pooling,
    # reshaping, activation, noise and loss layers)
    _HAS_PARAMS = True

    def has_params(self) -> bool:
        return self._HAS_PARAMS

    def param_count(self, input_shape: Shape) -> int:
        """The number of param entries at ``input_shape`` (shapes only: the
        params are made on the meta device)."""
        p, _ = self.init(None, tuple(input_shape), device=torch.device("meta"))

        def count(t):
            return (sum(count(v) for v in t.values()) if isinstance(t, dict)
                    else t.numel())

        return count(p)

    def output_shape(self, input_shape: Shape) -> Shape:
        """Feature shape (without batch dim) given input feature shape."""
        return input_shape

    def init(self, gen: Optional[torch.Generator], input_shape: Shape,
             dtype=torch.float32, device=None) -> Tuple[Params, State]:
        return {}, {}

    def apply(self, params: Params, state: State, x: torch.Tensor, *,
              training: bool = False, rng: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, State, Optional[torch.Tensor]]:
        raise NotImplementedError

    # --- serde ---
    def to_dict(self) -> dict:
        def norm(v):
            if isinstance(v, (tuple, list)):
                return [norm(x) for x in v]
            if isinstance(v, dict):
                return {k: norm(x) for k, x in v.items()}
            return v

        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and v != f.default:
                d[f.name] = norm(v)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Layer":
        d = dict(d)
        d.pop("@type", None)
        return cls(**d)


def layer_from_dict(d: dict) -> Layer:
    kind = d.get("@type")
    if kind not in LAYER_REGISTRY:
        raise ValueError(f"Unknown layer type '{kind}'. Known: "
                         f"{sorted(LAYER_REGISTRY)}")
    return LAYER_REGISTRY[kind].from_dict(d)


def apply_input_dropout(layer: Layer, x: torch.Tensor,
                        rng: Optional[torch.Generator],
                        training: bool) -> torch.Tensor:
    """The layer's ``dropout`` config applied to its *input*, in training
    only, as DL4J applies it; a layer with dropout and no generator
    raises."""
    if layer.dropout is None or not training:
        return x
    if rng is None:
        raise ValueError(f"Layer {layer.name or type(layer).__name__} has "
                         f"dropout but no rng was provided")
    return apply_dropout_config(rng, x, layer.dropout, training)


def draws_random(layer: Layer) -> bool:
    """Whether the layer draws from ``rng`` in training: a dropout config,
    a noise layer's rate or stddev, a block's dropout rates."""
    return bool(layer.dropout) or any(
        getattr(layer, f, 0) for f in ("rate", "stddev", "dropout_rate",
                                       "attn_dropout"))


def rewinding(fn, rng: Optional[torch.Generator]):
    """``fn`` for ``torch.utils.checkpoint``: its recompute in the
    backward draws what the first call drew (the generator is rewound to
    where the first call found it, then put back), so the gradient sees
    the forward's dropout masks, as the reference's recompute from the
    same key does. A generator's state cannot be read inside a CUDA graph
    capture, so callers wrap only layers that draw."""
    if rng is None:
        return fn
    saved = rng.get_state()
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        now = rng.get_state()
        rng.set_state(saved)
        try:
            return fn(*args)
        finally:
            rng.set_state(now)

    return run
