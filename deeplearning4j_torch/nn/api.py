"""Layer API — counterpart of ``deeplearning4j_tpu/nn/api.py``.

A ``Layer`` is a frozen dataclass of hyperparameters with the reference's
fields, and the two functions of the contract:

- ``init(gen, input_shape, dtype, device)`` returns ``(params, state)``,
  dicts of tensors drawn from the ``torch.Generator`` ``gen``;
- ``apply(params, state, x, *, training, rng, mask)`` returns
  ``(y, new_state, out_mask)``; ``rng`` is a ``torch.Generator`` or None
  (training-time dropout is not ported yet and raises).

``to_dict``/``layer_from_dict`` write and read the reference's ``"@type"``
JSON: a layer config written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Type

import torch

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


def no_training_dropout(layer: Layer, rate, training: bool) -> None:
    """Training-time dropout is not ported yet (ROADMAP.md, Queue 1):
    refuse it rather than run a training forward that skips it."""
    if training and rate:
        raise NotImplementedError(
            f"{layer.name or type(layer).__name__}: training-time dropout is "
            f"not ported yet")
