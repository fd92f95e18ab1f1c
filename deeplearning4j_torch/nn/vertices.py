"""Graph vertices — counterpart of ``deeplearning4j_tpu/nn/vertices.py``.

A vertex is a parameterless multi-input op inside a ``Graph``: a frozen
dataclass config with ``apply(inputs) -> output``. ``to_dict`` writes every
field, as the reference does, so a vertex written by either package loads
in the other. The port carries ``Merge`` and ``ElementWise``; the other
vertex types of the reference are not ported yet (ROADMAP.md, Queue 1,
"The rest of ``Graph`` and ``data/``") and ``vertex_from_dict`` names them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Type

import torch

from .api import Shape

VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}

_NOT_PORTED = ("L2Norm", "L2Distance", "Scale", "Shift", "Stack", "Unstack",
               "Subset", "ReshapeVertex", "PoolHelper", "LastTimeStepVertex",
               "DuplicateToTimeSeries", "ReverseTimeSeries")


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass(frozen=True)
class GraphVertex:
    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def output_shape(self, input_shapes: List[Shape]) -> Shape:
        return input_shapes[0]

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    @classmethod
    def from_dict(cls, d: dict):
        d = dict(d)
        d.pop("@type", None)
        return cls(**d)


def vertex_from_dict(d: dict) -> GraphVertex:
    kind = d.get("@type")
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"vertex type '{kind}' is not ported yet "
                                  f"(ROADMAP.md, Queue 1, 'The rest of Graph "
                                  f"and data/')")
    if kind not in VERTEX_REGISTRY:
        raise ValueError(f"Unknown vertex type '{kind}'")
    return VERTEX_REGISTRY[kind].from_dict(d)


@register_vertex
@dataclass(frozen=True)
class Merge(GraphVertex):
    """MergeVertex.java — concatenate along the feature (last) axis."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=-1)

    def output_shape(self, input_shapes):
        return input_shapes[0][:-1] + (sum(s[-1] for s in input_shapes),)


@register_vertex
@dataclass(frozen=True)
class ElementWise(GraphVertex):
    """ElementWiseVertex.java — op add, subtract, product, average or max,
    folded left to right in the inputs' dtype, as the reference folds."""

    op: str = "add"

    def apply(self, inputs):
        if self.op == "subtract":
            if len(inputs) != 2:
                raise ValueError("ElementWise subtract takes two inputs")
            return inputs[0] - inputs[1]
        if self.op == "average":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs)
        fold = {"add": torch.add, "product": torch.mul,
                "max": torch.maximum}.get(self.op)
        if fold is None:
            raise ValueError(self.op)
        out = inputs[0]
        for x in inputs[1:]:
            out = fold(out, x)
        return out
