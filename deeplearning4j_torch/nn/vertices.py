"""Graph vertices — counterpart of ``deeplearning4j_tpu/nn/vertices.py``.

A vertex is a parameterless multi-input op inside a ``Graph``: a frozen
dataclass config with ``apply(inputs) -> output``. ``to_dict`` writes every
field, as the reference does, so a vertex written by either package loads
in the other. Every vertex type of the reference is here; each writes
the reference's ops in order, its constants weak scalars rounded to the
inputs' dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Sequence, Type

import torch

from ..ops.activations import weak_scalar
from .api import Shape

VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}


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


@register_vertex
@dataclass(frozen=True)
class L2Norm(GraphVertex):
    """L2NormalizeVertex.java — x / max(||x||_2, eps) along the last axis,
    the norm as ``jnp.linalg.norm`` writes it: the squares in x's dtype,
    their sum accumulated in f32 and rounded once, then its square
    root."""

    eps: float = 1e-8

    def apply(self, inputs):
        (x,) = inputs
        norm = torch.sqrt(torch.sum((x * x).float(), dim=-1, keepdim=True)
                          .to(x.dtype))
        eps = torch.full((), self.eps, dtype=x.dtype, device=x.device)
        return x / torch.maximum(norm, eps)


@register_vertex
@dataclass(frozen=True)
class L2Distance(GraphVertex):
    """L2Vertex.java — the L2 distance of two inputs, (B, 1)."""

    def apply(self, inputs):
        a, b = inputs
        d = torch.sum(torch.square(a - b), dim=-1, keepdim=True)
        return torch.sqrt(d + weak_scalar(1e-12, d.dtype))

    def output_shape(self, input_shapes):
        return (1,)


@register_vertex
@dataclass(frozen=True)
class Scale(GraphVertex):
    """ScaleVertex.java — times a fixed scalar."""

    factor: float = 1.0

    def apply(self, inputs):
        return inputs[0] * weak_scalar(self.factor, inputs[0].dtype)


@register_vertex
@dataclass(frozen=True)
class Shift(GraphVertex):
    """ShiftVertex.java — plus a fixed scalar."""

    amount: float = 0.0

    def apply(self, inputs):
        return inputs[0] + weak_scalar(self.amount, inputs[0].dtype)


@register_vertex
@dataclass(frozen=True)
class Stack(GraphVertex):
    """StackVertex.java — the inputs stacked along the batch axis."""

    def apply(self, inputs):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclass(frozen=True)
class Unstack(GraphVertex):
    """UnstackVertex.java — slice ``index`` of ``num`` along the batch
    axis."""

    index: int = 0
    num: int = 1

    def apply(self, inputs):
        (x,) = inputs
        n = x.shape[0] // self.num
        return x[self.index * n: (self.index + 1) * n]


@register_vertex
@dataclass(frozen=True)
class Subset(GraphVertex):
    """SubsetVertex.java — features ``low`` to ``high``, both included."""

    low: int = 0
    high: int = 0

    def apply(self, inputs):
        (x,) = inputs
        return x[..., self.low: self.high + 1]

    def output_shape(self, input_shapes):
        return input_shapes[0][:-1] + (self.high - self.low + 1,)


@register_vertex
@dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """ReshapeVertex.java — reshape all but the batch axis."""

    shape: Sequence[int] = ()

    def apply(self, inputs):
        (x,) = inputs
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_shape(self, input_shapes):
        return tuple(self.shape)


@register_vertex
@dataclass(frozen=True)
class PoolHelper(GraphVertex):
    """PoolHelperVertex.java — drops the first row and column (GoogLeNet's
    padding quirk)."""

    def apply(self, inputs):
        (x,) = inputs
        return x[:, 1:, 1:, :]

    def output_shape(self, input_shapes):
        h, w, c = input_shapes[0]
        return (h - 1, w - 1, c)


@register_vertex
@dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """rnn/LastTimeStepVertex.java — (B, T, F) -> (B, F), the last step."""

    def apply(self, inputs):
        (x,) = inputs
        return x[:, -1]

    def output_shape(self, input_shapes):
        return (input_shapes[0][-1],)


@register_vertex
@dataclass(frozen=True)
class DuplicateToTimeSeries(GraphVertex):
    """rnn/DuplicateToTimeSeriesVertex.java — (B, F) -> (B, T, F), T from
    the second input."""

    def apply(self, inputs):
        x, time_ref = inputs
        return x[:, None, :].expand(x.shape[0], time_ref.shape[1],
                                    x.shape[-1])

    def output_shape(self, input_shapes):
        return (input_shapes[1][0], input_shapes[0][-1])


@register_vertex
@dataclass(frozen=True)
class ReverseTimeSeries(GraphVertex):
    """rnn/ReverseTimeSeriesVertex.java — the time axis reversed."""

    def apply(self, inputs):
        (x,) = inputs
        return torch.flip(x, dims=(1,))
